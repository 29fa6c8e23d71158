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
// Bound on the H100 (80 GB HBM3 at 3.35 TB/s): all three are elementwise
// passes with a handful of float32 operations per element, so
// device-memory bytes bound them, never arithmetic.
//   momentum_sign_pack moves 10.125 B per element for a bf16 gradient
//     and float32 momentum (g read 2, m read 4, m' written 4, one packed
//     bit 1/8); on the 620,756,992-element glm4-9b unembedding: 6.29 GB,
//     1.88 ms. With bf16 momentum (the glm4-9b preset's) 6.125 B: 3.80 GB,
//     1.135 ms; 6 B without the words (the count wire's encode): 1.112 ms.
//   apply_vote moves 4.125 B per element for bf16 parameters
//     (p read 2 and written 2, one vote bit 1/8): 2.56 GB, 0.764 ms;
//     8.125 B for float32 parameters: 5.04 GB, 1.51 ms.
//   apply_ternary_vote moves 4.25 B per element (two vote bits): 2.64 GB,
//     0.788 ms.
//
// momentum_sign_pack: one thread per element, consecutive threads on
// consecutive elements, so every load and store is coalesced. The TPU
// kernel packs with a 32-way shift/OR tree over a (8, 4096) VMEM block; on
// Hopper warp lane j already holds element 32k + j, so one
// __ballot_sync(m' >= 0) *is* packed word k and lane 0 stores it. Lanes
// past n vote true, which gives the padding bits of the last word the
// value +1 (sign(0) = +1), the same bits the reference's zero padding
// yields.
//
// The two applies are one template over the parameter type and the vote
// decoder. A pass at the byte bound needs ~2-3 MB of loads in flight
// (3.35 TB/s x ~0.7 us of device-memory latency). One bf16 element per
// thread, as the first version did, keeps ~0.5 MB in flight card-wide and
// ran latency-bound at ~1.35 TB/s. So a warp owns a segment of 1024
// consecutive elements (32 vote words on the 1-bit wire, 64 on the 2-bit
// one), and each thread issues all of its 16-byte parameter loads (64 B
// of bf16, 128 B of float32) and its vote words before it uses any of
// them; it then decodes the votes from registers and writes 16-byte
// stores. Lane j owns bytes 16j..16j+15 of each 512-byte chunk of the
// segment, so each load instruction of a warp reads 512 contiguous bytes;
// the segment's vote words are loaded one per lane and shuffled to the
// lanes that decode them (on the 1-bit wire four lanes share a word in
// bf16, eight in float32). One warp takes one segment (one thread per
// vote word on the 1-bit wire) and the grid covers them all. Each choice
// beat the one rejected on an H100 (PERF.md, Findings of the apply
// redesign, has the times): lane j owning elements 32j..32j+31, and a
// grid-stride loop over the segments.
// p and out are read and written with streaming hints (__ldcs / __stcs):
// nothing reads them again in this kernel. A segment past n (the ragged
// tail), or a p or out that starts off a 16-byte boundary (a view such as
// buf[1:]), takes the element path of the same kernel: lane j updates
// elements 32i + j of the segment, i = 0..31, eight loads at a time.
//
// Aliasing. out may be p itself (the trainer updates in place), so
// neither is __restrict__ and p is not read through the non-coherent path
// (__ldg). Every element is read and written by one thread, which loads
// it before it stores it.
//
// Rounding. The plain versions round each product and each sum on its own.
// __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from contracting the
// expression into an FMA, which would move m' by an ulp and could flip a
// sign bit near zero; with them the kernels are bit-equal to the plain
// versions. beta and 1 - beta arrive as float32 computed on the host in
// double (as JAX folds the Python constant); for bf16 momentum the wrapper
// also rounds them to bf16, since JAX computes `beta * m` of a bf16 m in
// bf16 with the constant rounded to bf16 (0.9 -> 0.8984375) and rounds
// after each operation: one rounding of the float32 expression differs
// from it on about a third of the elements. eta and lambda are runtime
// arguments, so a learning-rate schedule never rebuilds the kernel.
//
// Subnormals. build.py compiles with -ftz=true, so every float32 operation
// and comparison here reads a subnormal operand (a bf16 one too, once
// widened to float32) as a zero of its sign and flushes a subnormal result
// to one, as XLA does in the reference: beta * m of a subnormal m is a
// zero, m' is never stored subnormal, and the sign bit taken of m' as
// stored is that of a flushed value.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;
// elements of the segment one warp of an apply kernel owns
constexpr int64_t kSegment = 32 * 32;
// resident blocks of an apply kernel per SM: 1024 threads, each with 64 B
// (bf16) or 128 B (float32) of loads in flight, which caps the kernel at 64
// registers a thread. The cap is there for the element path, which shares
// the kernel's registers: uncapped, with 32 loads in flight, it took 156
// and left one block per SM. Under the cap ptxas (whose lines
// chip_smoke.py prints) gives 58 registers to bf16 1-bit, 63 to bf16
// 2-bit and 64 to both float32 instantiations; float32 2-bit spills 8 B.
// The bf16 ones the trainer runs do not spill. A later change to the
// element path shows there as spills, not as lost occupancy.
constexpr int kApplyBlocksPerSM = 4;

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
// x rounded to the nearest bf16 (ties to even), as a float32
__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The momentum update of one element, in M's own type, as the reference
// rounds it. float32 m: m' = b*m + c*g, each product and the sum rounded
// on their own. bf16 m: JAX rounds the weakly typed constants to bf16
// (b and c arrive already rounded), rounds g to bf16, rounds each product
// to bf16 and then the float32 sum of the two; both products are exact in
// float32 (bf16 x bf16), so __fmul_rn only keeps nvcc from fusing them
// into the add.
template <typename Mt> struct Momentum;
template <> struct Momentum<float> {
  static __device__ __forceinline__ float step(float b, float m, float c,
                                               float g) {
    return __fadd_rn(__fmul_rn(b, m), __fmul_rn(c, g));
  }
};
template <> struct Momentum<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 step(float b, float m,
                                                       float c, float g) {
    const float gb = bf16_rn(g);
    return __float2bfloat16_rn(
        __fadd_rn(bf16_rn(__fmul_rn(b, m)), bf16_rn(__fmul_rn(c, gb))));
  }
};

// m_out may alias m: each thread reads its element before writing it.
// A null `packed` (the same for every thread) writes m' only. The sign bit
// is taken of m' as stored (a bf16 -0.0 counts as +).
template <typename G, typename Mt>
__global__ void momentum_sign_pack_kernel(const G* __restrict__ g,
                                          const Mt* m, Mt* m_out,
                                          uint32_t* __restrict__ packed,
                                          int64_t n, int64_t w, float b,
                                          float c) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool nonneg = true;
  if (i < n) {
    const Mt mi = Momentum<Mt>::step(b, to_f32(m[i]), c, to_f32(g[i]));
    m_out[i] = mi;
    nonneg = to_f32(mi) >= 0.0f;
  }
  if (packed == nullptr) return;
  // every lane of the warp takes part: the grid covers whole warps
  const unsigned word = __ballot_sync(0xffffffffu, nonneg);
  const int64_t k = i >> 5;
  if ((threadIdx.x & 31) == 0 && k < w) packed[k] = word;
}

// Vote decoders: vote(b, i) is the vote of field i of the bits b (field 0
// in the low bits).
struct SignVote {      // the 1-bit wire: 1 -> +1, 0 -> -1
  static constexpr int kBits = 1;
  static __device__ __forceinline__ float vote(uint32_t b, int i) {
    return ((b >> i) & 1u) ? 1.0f : -1.0f;
  }
};
struct TernaryVote {   // the 2-bit wire: 01 -> +1, 11 -> -1, 00 and 10 -> 0
  static constexpr int kBits = 2;
  static __device__ __forceinline__ float vote(uint32_t b, int i) {
    const uint32_t f = (b >> (2 * i)) & 3u;
    return f == 1u ? 1.0f : (f == 3u ? -1.0f : 0.0f);
  }
};

// p - eta * (vote + wd * p). A 0 vote leaves p - eta * (0 + wd * p), so
// with no weight decay an abstaining coordinate keeps its value exactly.
__device__ __forceinline__ float update(float p, float vote, float eta,
                                        float wd) {
  return __fsub_rn(p, __fmul_rn(eta, __fadd_rn(vote, __fmul_rn(wd, p))));
}

// 16 bytes of parameters, updated by the vote fields in the low bits of b.
template <typename P> struct Piece;
template <> struct Piece<float> {
  static constexpr int kElems = 4;
  template <typename D>
  static __device__ __forceinline__ uint4 apply(uint4 q, uint32_t b,
                                                float eta, float wd) {
    uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = __float_as_uint(
          update(__uint_as_float(w[i]), D::vote(b, i), eta, wd));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Piece<__nv_bfloat16> {
  static constexpr int kElems = 8;
  template <typename D>
  static __device__ __forceinline__ uint4 apply(uint4 q, uint32_t b,
                                                float eta, float wd) {
    uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of the float32 of the same value
      const float lo = __uint_as_float(w[i] << 16);
      const float hi = __uint_as_float(w[i] & 0xffff0000u);
      const uint32_t rlo = __bfloat16_as_ushort(
          __float2bfloat16_rn(update(lo, D::vote(b, 2 * i), eta, wd)));
      const uint32_t rhi = __bfloat16_as_ushort(
          __float2bfloat16_rn(update(hi, D::vote(b, 2 * i + 1), eta, wd)));
      w[i] = rlo | (rhi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// A whole segment at `base`, p and out 16-byte aligned: kPieces 16-byte
// loads per lane, all issued before the first use.
template <typename P, typename D>
__device__ __forceinline__ void apply_segment_vec(
    const P* p, const uint32_t* __restrict__ v, P* out, int64_t base,
    int lane, float eta, float wd) {
  constexpr int kE = Piece<P>::kElems;
  constexpr int kPieces = 32 / kE;      // 4 for bf16, 8 for float32
  constexpr int kB = D::kBits;
  uint32_t w[kB];
  uint4 q[kPieces];
  uint32_t bits[kPieces];
  // piece c of lane j: elements (32c + j) * kE .. + kE of the segment
  const uint32_t* vs = v + ((base * kB) >> 5);
#pragma unroll
  for (int b = 0; b < kB; ++b) w[b] = __ldcs(vs + 32 * b + lane);
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    q[c] = __ldcs(reinterpret_cast<const uint4*>(
        p + base + (int64_t)(32 * c + lane) * kE));
  }
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    const int f = (32 * c + lane) * kE * kB;   // the piece's first vote bit
    bits[c] = __shfl_sync(kFullWarp, w[(c * kE * kB) >> 5], (f >> 5) & 31)
              >> (f & 31);
  }
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    uint4* dst = reinterpret_cast<uint4*>(
        out + base + (int64_t)(32 * c + lane) * kE);
    __stcs(dst, Piece<P>::template apply<D>(q[c], bits[c], eta, wd));
  }
}

// The element path: lane j updates elements base + 32i + j below n, so each
// load and store of the warp stays coalesced; eight loads per lane are in
// flight at a time, which keeps the kernel's registers (and so its
// occupancy on the 16-byte path) as the 16-byte path needs them.
template <typename P, typename D>
__device__ __forceinline__ void apply_segment_elems(
    const P* p, const uint32_t* __restrict__ v, P* out, int64_t n,
    int64_t base, int lane, float eta, float wd) {
  constexpr int kBatch = 8;
#pragma unroll 1
  for (int i0 = 0; i0 < 32; i0 += kBatch) {
    float x[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int64_t e = base + 32 * (i0 + i) + lane;
      x[i] = e < n ? to_f32(p[e]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int64_t e = base + 32 * (i0 + i) + lane;
      if (e < n) {
        const int64_t f = e * D::kBits;
        out[e] = from_f32<P>(
            update(x[i], D::vote(v[f >> 5] >> (f & 31), 0), eta, wd));
      }
    }
  }
}

// out may alias p. `vec`: p and out lie on 16-byte boundaries. Every
// branch below is the same for the whole warp, as the shuffles of the
// 16-byte path need.
template <typename P, typename D>
__global__ void __launch_bounds__(kThreads, kApplyBlocksPerSM)
apply_kernel(const P* p, const uint32_t* __restrict__ v, P* out, int64_t n,
             float eta, float wd, bool vec) {
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) * kSegment;
  if (base >= n) return;
  if (vec && base + kSegment <= n) {
    apply_segment_vec<P, D>(p, v, out, base, lane, eta, wd);
  } else {
    apply_segment_elems<P, D>(p, v, out, n, base, lane, eta, wd);
  }
}

unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <typename G, typename Mt>
int launch_msp(const void* g, const void* m, void* m_out, void* packed,
               int64_t n, float b, float c, void* stream) {
  const int64_t w = (n + 31) / 32;
  if (n > 0) {
    momentum_sign_pack_kernel<G, Mt>
        <<<blocks_for(w * 32), kThreads, 0, (cudaStream_t)stream>>>(
            (const G*)g, (const Mt*)m, (Mt*)m_out, (uint32_t*)packed, n, w,
            b, c);
  }
  return (int)cudaGetLastError();
}

template <typename P, typename D>
int launch_apply(const void* p, const void* v, void* out, int64_t n,
                 float eta, float wd, void* stream) {
  if (n > 0) {
    const uintptr_t pa = reinterpret_cast<uintptr_t>(p);
    const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
    const bool vec = ((pa | oa) & 15) == 0;
    const int64_t segments = (n + kSegment - 1) / kSegment;
    apply_kernel<P, D><<<blocks_for(segments * 32), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const P*)p, (const uint32_t*)v, (P*)out, n, eta, wd, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int momentum_sign_pack_f32(const void* g, const void* m, void* m_out,
                           void* packed, int64_t n, float b, float c,
                           void* stream) {
  return launch_msp<float, float>(g, m, m_out, packed, n, b, c, stream);
}

int momentum_sign_pack_bf16(const void* g, const void* m, void* m_out,
                            void* packed, int64_t n, float b, float c,
                            void* stream) {
  return launch_msp<__nv_bfloat16, float>(g, m, m_out, packed, n, b, c,
                                          stream);
}

// bf16 momentum: b and c must be bf16 values already (the wrapper rounds
// them as JAX rounds its weakly typed constants)
int momentum_sign_pack_f32_mbf16(const void* g, const void* m, void* m_out,
                                 void* packed, int64_t n, float b, float c,
                                 void* stream) {
  return launch_msp<float, __nv_bfloat16>(g, m, m_out, packed, n, b, c,
                                          stream);
}

int momentum_sign_pack_bf16_mbf16(const void* g, const void* m, void* m_out,
                                  void* packed, int64_t n, float b, float c,
                                  void* stream) {
  return launch_msp<__nv_bfloat16, __nv_bfloat16>(g, m, m_out, packed, n, b,
                                                  c, stream);
}

int apply_vote_f32(const void* p, const void* v, void* out, int64_t n,
                   float eta, float wd, void* stream) {
  return launch_apply<float, SignVote>(p, v, out, n, eta, wd, stream);
}

int apply_vote_bf16(const void* p, const void* v, void* out, int64_t n,
                    float eta, float wd, void* stream) {
  return launch_apply<__nv_bfloat16, SignVote>(p, v, out, n, eta, wd,
                                               stream);
}

int apply_ternary_vote_f32(const void* p, const void* v, void* out, int64_t n,
                           float eta, float wd, void* stream) {
  return launch_apply<float, TernaryVote>(p, v, out, n, eta, wd, stream);
}

int apply_ternary_vote_bf16(const void* p, const void* v, void* out,
                            int64_t n, float eta, float wd, void* stream) {
  return launch_apply<__nv_bfloat16, TernaryVote>(p, v, out, n, eta, wd,
                                                  stream);
}

}  // extern "C"
