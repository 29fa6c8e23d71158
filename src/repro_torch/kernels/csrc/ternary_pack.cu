// Ternary 2-bit packing and unpacking for Hopper (sm_90a): the wire of the
// ternary2bit codec.
//
// ternary_pack replaces the Pallas kernel
//   src/repro/kernels/ternary_pack.py:61 ternary_pack_2d (pallas_call at :67)
// ternary_unpack has no Pallas counterpart: the reference decodes the packed
// majority with jnp (src/repro/kernels/ops.py:155 ternary_unpack).
// The tally between them, the counterpart of
//   src/repro/kernels/ternary_pack.py:79 ternary_tally_packed
// is ternary_majority in vote.cu, one template with the 1-bit tally.
//
// Format: 16 symbols per word, little-endian, field j of word k in bits
// 2j..2j+1 holds element 16k + j: +1 -> 0b01, -1 -> 0b11, 0 (abstain) ->
// 0b00. Padding fields past n are 0b00, each row padded on its own: the
// ternary wire abstains there, where the 1-bit wire pads with +1 bits.
//
// ternary_pack: (rows, n) -> (rows, ceil(n/16)) words. int8 symbols keep
//   their low two bits (the TPU kernel's s & 3, so any int8 input packs as
//   the reference packs it); f32 / bf16 values are packed as their
//   sign_ternary (x > 0 -> 0b01, x < 0 -> 0b11, +0.0 / -0.0 -> 0b00), so a
//   caller never makes an int8 or int32 copy of a float payload.
// ternary_unpack: (w,) words -> (n,) of {-1, 0, +1} in int8, float32 or
//   bf16 (the float outputs give Mode B's momentum update its g, with no
//   cast pass; 0 is +0.0). A field reads +1 only as 0b01 and -1 only as
//   0b11: the unused pattern 0b10 reads 0, as the reference's where()
//   decodes it.
//
// Bound on the H100 (3.35 TB/s): a mask, a compare or a shift per element,
// so device-memory bytes bound both. At the glm4-9b unembedding
// (n = 620,756,992):
//   ternary_pack of the (4, n) int8 wire signs reads 4n B and writes n B:
//     3.10 GB, 0.93 ms; of one f32 momentum row, 4n B + n/4 B: 0.79 ms.
//   ternary_unpack reads n/4 B and writes n B: 0.78 GB, 0.23 ms (int8);
//     n/4 + 2n B, 1.40 GB, 0.42 ms (bf16); n/4 + 4n B, 2.64 GB, 0.79 ms
//     (float32).
//
// Design. The TPU kernels work on (8, 2048) VMEM blocks with unrolled
// shift/OR trees. Here one thread owns one output word. Packing reads the
// word's 16 elements with 16-byte loads when every row starts 16-byte
// aligned (n % 16 == 0 and an aligned base; one load for int8, two for
// bf16, four for f32), element by element otherwise; the grid's y
// dimension walks the rows, so a word never straddles two rows. Unpacking
// gives each thread one 16-byte store of symbols (16 int8, 8 bf16 or 4
// float32, from one word), so a warp writes 512 contiguous bytes.
// Rejected: a thread per word writing its 16 symbols with one to four
// 16-byte stores (the int8 design carried over): on the H100 the float32
// output took 1.89 ms at the glm4-9b unembedding, 42 % of its bound, and
// bf16 0.65 ms (PERF.md, the kernel table).
// Rejected: no design of these two. The tally that was here (one thread
// per word, 16 counters) gave way to vote.cu's bit-sliced one; PERF.md,
// kernel table row 8, has its times.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

// A float32 or bf16 subnormal abstains (0b00), as the reference (XLA) reads
// it as a zero: field_of tests the bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr int kFields = 16;   // symbols per word

// sign_ternary on the bits of a float32: zeros, subnormals (read as zeros,
// as the reference's XLA reads them) and NaN -> 0b00. An integer test, so
// it never depends on ptxas keeping -ftz=true on a compare (it dropped it
// on one compare of bitpack.cu's, see there).
__device__ __forceinline__ uint32_t field_of(float x) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t a = u & 0x7fffffffu;
  if (a < 0x00800000u || a > 0x7f800000u) return 0u;
  return (u >> 31) ? 3u : 1u;
}
__device__ __forceinline__ uint32_t field_of(__nv_bfloat16 x) {
  return field_of(__bfloat162float(x));
}
__device__ __forceinline__ uint32_t field_of(int8_t s) {
  return (uint32_t)(uint8_t)s & 3u;
}

// The fields of the elements held in one 32-bit chunk of raw memory, the
// first element's field in bits 0..1.
template <typename T> __device__ __forceinline__ uint32_t chunk_fields(uint32_t u);
template <> __device__ __forceinline__ uint32_t chunk_fields<int8_t>(uint32_t u) {
  return (u & 0x3u) | ((u >> 6) & 0xCu) | ((u >> 12) & 0x30u) |
         ((u >> 18) & 0xC0u);
}
template <> __device__ __forceinline__ uint32_t
chunk_fields<__nv_bfloat16>(uint32_t u) {
  // a bf16's bits shifted into the top half are the same value as f32
  return field_of(__uint_as_float(u << 16)) |
         (field_of(__uint_as_float(u & 0xFFFF0000u)) << 2);
}
template <> __device__ __forceinline__ uint32_t chunk_fields<float>(uint32_t u) {
  return field_of(__uint_as_float(u));
}

// blockIdx.y is the row within this launch's slab of rows
template <typename T, bool kAligned>
__global__ void ternary_pack_kernel(const T* __restrict__ x,
                                    uint32_t* __restrict__ out, int64_t n,
                                    int64_t w) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= w) return;
  const T* xr = x + (int64_t)blockIdx.y * n;
  uint32_t acc = 0;
  if (kAligned) {
    // n % 16 == 0: the word's 16 elements are 16 * sizeof(T) aligned bytes
    constexpr int kPer = 4 / sizeof(T);          // elements per chunk
    const uint4* src = reinterpret_cast<const uint4*>(xr + k * kFields);
#pragma unroll
    for (int q = 0; q < (int)sizeof(T); ++q) {
      const uint4 v = src[q];
      const uint32_t c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc |= chunk_fields<T>(c[e]) << (2 * kPer * (4 * q + e));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kFields; ++j) {
      const int64_t col = k * kFields + j;
      if (col < n) acc |= field_of(xr[col]) << (2 * j);
    }
  }
  out[(int64_t)blockIdx.y * w + k] = acc;
}

// a field's symbol as the bits of an int8, a bf16 or a float32: +1 only
// for 0b01, -1 only for 0b11, else +0
template <typename T> __device__ __forceinline__ uint32_t symbol_bits(uint32_t f);
template <> __device__ __forceinline__ uint32_t symbol_bits<int8_t>(uint32_t f) {
  return f == 1u ? 0x01u : (f == 3u ? 0xFFu : 0x00u);
}
template <> __device__ __forceinline__ uint32_t
symbol_bits<__nv_bfloat16>(uint32_t f) {
  return f == 1u ? 0x3F80u : (f == 3u ? 0xBF80u : 0x0000u);
}
template <> __device__ __forceinline__ uint32_t symbol_bits<float>(uint32_t f) {
  return f == 1u ? 0x3F800000u : (f == 3u ? 0xBF800000u : 0x00000000u);
}

// A thread owns the 16 bytes of output at [i0, i0 + kPerThread): 16 int8,
// 8 bf16 or 4 float32 symbols, all from one word (kPerThread divides 16),
// so neighbouring threads write neighbouring 16 bytes.
template <typename T>
__global__ void ternary_unpack_kernel(const uint32_t* __restrict__ v,
                                      T* __restrict__ out, int64_t n) {
  constexpr int kPerThread = 16 / sizeof(T);
  constexpr int kPerLane = 4 / sizeof(T);        // symbols per 32-bit lane
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i0 = t * kPerThread;
  if (i0 >= n) return;
  const uint32_t bits = v[i0 / kFields] >> (2 * (i0 % kFields));
  if (i0 + kPerThread > n) {                       // the ragged tail
    for (int j = 0; j < n - i0; ++j) {
      const uint32_t s = symbol_bits<T>((bits >> (2 * j)) & 3u);
      out[i0 + j] = *reinterpret_cast<const T*>(&s);
    }
    return;
  }
  uint32_t p[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    p[q] = 0;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      p[q] |= symbol_bits<T>((bits >> (2 * (kPerLane * q + e))) & 3u)
              << (8 * sizeof(T) * e);
  }
  // out comes from torch.empty, so out + i0 is 16-byte aligned
  *reinterpret_cast<uint4*>(out + i0) = make_uint4(p[0], p[1], p[2], p[3]);
}

unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <typename T, bool kAligned>
void launch_pack_rows(const T* x, uint32_t* out, int64_t rows, int64_t n,
                      int64_t w, cudaStream_t stream) {
  for (int64_t r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const int64_t slab = rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY;
    ternary_pack_kernel<T, kAligned>
        <<<dim3(blocks_for(w), (unsigned)slab), kThreads, 0, stream>>>(
            x + r0 * n, out + r0 * w, n, w);
  }
}

template <typename T>
int launch_pack(const void* x, void* out, int64_t rows, int64_t n,
                void* stream) {
  const int64_t w = (n + kFields - 1) / kFields;
  if (rows > 0 && w > 0) {
    const bool aligned =
        n % kFields == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (aligned)
      launch_pack_rows<T, true>((const T*)x, (uint32_t*)out, rows, n, w,
                                (cudaStream_t)stream);
    else
      launch_pack_rows<T, false>((const T*)x, (uint32_t*)out, rows, n, w,
                                 (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_unpack(const void* v, void* out, int64_t n, void* stream) {
  if (n > 0) {
    constexpr int kPerThread = 16 / sizeof(T);
    const int64_t threads = (n + kPerThread - 1) / kPerThread;
    ternary_unpack_kernel<T><<<blocks_for(threads), kThreads, 0,
                               (cudaStream_t)stream>>>((const uint32_t*)v,
                                                       (T*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ternary_pack_i8(const void* x, void* out, int64_t rows, int64_t n,
                    void* stream) {
  return launch_pack<int8_t>(x, out, rows, n, stream);
}

int ternary_pack_f32(const void* x, void* out, int64_t rows, int64_t n,
                     void* stream) {
  return launch_pack<float>(x, out, rows, n, stream);
}

int ternary_pack_bf16(const void* x, void* out, int64_t rows, int64_t n,
                      void* stream) {
  return launch_pack<__nv_bfloat16>(x, out, rows, n, stream);
}

int ternary_unpack_i8(const void* v, void* out, int64_t n, void* stream) {
  return launch_unpack<int8_t>(v, out, n, stream);
}

int ternary_unpack_bf16(const void* v, void* out, int64_t n, void* stream) {
  return launch_unpack<__nv_bfloat16>(v, out, n, stream);
}

int ternary_unpack_f32(const void* v, void* out, int64_t n, void* stream) {
  return launch_unpack<float>(v, out, n, stream);
}

}  // extern "C"
