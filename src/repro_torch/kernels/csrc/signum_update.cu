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
// momentum_sign_pack. A pass at the byte bound needs ~2-3 MB of loads in
// flight (3.35 TB/s x ~0.7 us of device-memory latency); one element per
// thread, the first design, kept 4-6 B a thread in flight (~1.1-1.6 MB
// card-wide) and reached 49 % (bf16 m) and 74 % (float32 m) of the bound.
// So it takes the applies' layout (below): a warp owns a segment of 1024
// consecutive elements, 32 packed words, and each lane issues all of its
// loads of g and m (32 elements of each) before it uses any of them. Lane j
// owns piece c = elements (32c + j) * kE .. + kE of the segment, so each
// load instruction of the warp reads 32 * kE contiguous elements. kE is 8
// where g and m are both bf16 (one 16-byte load of each a piece: 64 B of g
// and 64 B of m a lane, 512 contiguous bytes an instruction) and 4 where
// either is float32: the float32 array takes 16-byte loads (512 bytes an
// instruction), a bf16 one 8-byte loads of the same 4 elements (256 bytes),
// so that a lane holds the same elements of g and m without shuffles. m' is
// computed in registers with Momentum<Mt>::step and written with streaming
// 16-byte (8-byte) stores. Each piece gives a field of kE sign bits; the
// fields of word k lie in the 32 / kE lanes that hold elements 32k..32k+31,
// one field per lane, so a butterfly of log2(32 / kE) xor-shuffles
// transposes each group of lanes' fields into whole words and one more
// shuffle hands word k to lane k, which stores the segment's 32 words as one
// coalesced 128-byte store. A segment past n (the ragged tail), or a g, m or
// m_out that starts off a 16-byte boundary (a voter's row of a stacked leaf
// can start anywhere), takes the element path of the same kernel: lane j
// updates elements 32i + j of the segment, i = 0..31, eight loads at a time,
// and one __ballot_sync of m' >= 0 per i *is* word i; lanes past n vote
// true, which gives the padding bits of the last word the value +1
// (sign(0) = +1), the bits the reference's zero padding yields. A null
// `packed` writes m' only (the codecs' and the count wire's encode).
// Aliasing as in the applies: m_out may be m, so neither is __restrict__
// and m is not read through __ldg; each element is loaded and stored by
// one thread.
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
// zero and m' is never stored subnormal. The sign bit is an integer test of
// m' as stored (nonneg_bits: a zero or subnormal exponent reads as 0, so
// -0.0 gives 1; NaN gives 0), so it does not depend on the flag.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullWarp = 0xffffffffu;
// elements of the segment one warp owns (momentum_sign_pack and the applies)
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

// m' >= 0 on the bits of a float32, as bitpack.cu tests it: a zero or
// subnormal exponent reads as 0 (+0.0 and -0.0 both give 1), NaN gives 0.
__device__ __forceinline__ bool nonneg_bits(uint32_t u) {
  const uint32_t a = u & 0x7fffffffu;
  return a < 0x00800000u || (!(u >> 31) && a <= 0x7f800000u);
}

// The bits of a stored momentum value (a bf16 in the low 16 bits), and its
// sign bit.
__device__ __forceinline__ uint32_t raw_bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ uint32_t raw_bits(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ bool nonneg_stored(float x) {
  return nonneg_bits(__float_as_uint(x));
}
__device__ __forceinline__ bool nonneg_stored(__nv_bfloat16 x) {
  return nonneg_bits((uint32_t)__bfloat16_as_ushort(x) << 16);
}

// Element e of the elements of T packed into 32-bit words w, as a float32
// (a bf16 is the high half of the float32 of the same value).
template <typename T> __device__ __forceinline__ float elem(const uint32_t* w,
                                                            int e);
template <> __device__ __forceinline__ float elem<float>(const uint32_t* w,
                                                         int e) {
  return __uint_as_float(w[e]);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(
    const uint32_t* w, int e) {
  return __uint_as_float((e & 1) ? (w[e >> 1] & 0xffff0000u)
                                 : (w[e >> 1] << 16));
}

// kW 32-bit words (16 or 8 bytes) at `src`, streamed (__ldcs: not the
// non-coherent path, which an aliased m may not take); and stored back.
template <int kW>
__device__ __forceinline__ void load_cs(const void* src, uint32_t* w) {
  if constexpr (kW == 4) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(src));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
    static_assert(kW == 2, "a piece is 8 or 16 bytes");
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(src));
    w[0] = q.x; w[1] = q.y;
  }
}
template <int kW>
__device__ __forceinline__ void store_cs(void* dst, const uint32_t* w) {
  if constexpr (kW == 4) {
    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(w[0], w[1], w[2], w[3]));
  } else {
    static_assert(kW == 2, "a piece is 8 or 16 bytes");
    __stcs(reinterpret_cast<uint2*>(dst), make_uint2(w[0], w[1]));
  }
}

// The layout of a momentum_sign_pack segment: kE elements a piece (8 where
// g and m are both bf16, else 4), 32 / kE pieces a lane and as many lanes a
// word; resident blocks per SM, which cap the registers of a thread (65536
// / (256 * kBlocks)): the loads in flight take 64 registers for float32 g
// and m, 48 where one is bf16 and 32 where both are.
template <typename G, typename Mt> struct MspLayout {
  static constexpr int kE = (sizeof(G) == 2 && sizeof(Mt) == 2) ? 8 : 4;
  static constexpr int kPieces = 32 / kE;
  static constexpr int kBlocks = (sizeof(G) == 4 && sizeof(Mt) == 4) ? 2 : 3;
};

// The fields of kE bits whose piece index p has bit d clear.
__host__ __device__ constexpr uint32_t low_fields(int kE, int d) {
  uint32_t mask = 0;
  for (int p = 0; p < 32 / kE; ++p)
    if (!(p & d)) mask |= ((1u << kE) - 1u) << (kE * p);
  return mask;
}

// x holds this lane's kE-bit fields, field p from its piece p. Lane j = G*q
// + i (G = 32 / kE lanes a group) has field p = the bits of elements
// kE * (32p + G*q + i) .., which word kE*p + q holds at bit kE*i. A
// butterfly over the group's lanes transposes the G x G fields (each stage
// swaps bit d of the lane and of the field index where they differ), so
// lane G*q + p ends with word kE*p + q; lane k then takes word k.
template <int kE>
__device__ __forceinline__ uint32_t fields_to_word(uint32_t x, int lane) {
  constexpr int kG = 32 / kE;
#pragma unroll
  for (int d = kG / 2; d >= 1; d /= 2) {
    const uint32_t low = low_fields(kE, d);
    const int shift = kE * d;
    const uint32_t other = __shfl_xor_sync(kFullWarp, x, d);
    x = (lane & d) ? ((x & ~low) | ((other >> shift) & low))
                   : ((x & low) | ((other << shift) & ~low));
  }
  return __shfl_sync(kFullWarp, x, kG * (lane % kE) + lane / kE);
}

// A whole segment at `base`, g, m and m_out 16-byte aligned: every load of
// the lane issued before the first use; m' written back piece by piece.
// Returns the lane's sign fields (see fields_to_word).
template <typename G, typename Mt>
__device__ __forceinline__ uint32_t msp_segment_vec(const G* g, const Mt* m,
                                                    Mt* m_out, int64_t base,
                                                    int lane, float b,
                                                    float c) {
  constexpr int kE = MspLayout<G, Mt>::kE;
  constexpr int kP = MspLayout<G, Mt>::kPieces;
  constexpr int kGW = kE * (int)sizeof(G) / 4;    // 32-bit words a piece
  constexpr int kMW = kE * (int)sizeof(Mt) / 4;
  uint32_t gw[kP][kGW], mw[kP][kMW];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int64_t e0 = base + (int64_t)(32 * p + lane) * kE;
    load_cs<kGW>(g + e0, gw[p]);
    load_cs<kMW>(m + e0, mw[p]);
  }
  uint32_t fields = 0;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    uint32_t out[kMW];
#pragma unroll
    for (int i = 0; i < kMW; ++i) out[i] = 0;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const Mt v = Momentum<Mt>::step(b, elem<Mt>(mw[p], e), c,
                                      elem<G>(gw[p], e));
      const int bits = 8 * (int)sizeof(Mt);
      out[e * bits / 32] |= raw_bits(v) << (e * bits % 32);
      fields |= (uint32_t)nonneg_stored(v) << (kE * p + e);
    }
    store_cs<kMW>(m_out + base + (int64_t)(32 * p + lane) * kE, out);
  }
  return fields;
}

// The element path: lane j updates elements base + 32i + j below n, eight
// loads of g and m at a time, and the warp's ballot of their sign bits is
// word i (lanes past n vote true: the padding bits). Returns word `lane`.
template <typename G, typename Mt>
__device__ __forceinline__ uint32_t msp_segment_elems(
    const G* __restrict__ g, const Mt* m, Mt* m_out, int64_t n, int64_t base,
    int lane, float b, float c) {
  constexpr int kBatch = 8;
  uint32_t word = 0;
#pragma unroll 1
  for (int i0 = 0; i0 < 32; i0 += kBatch) {
    float gx[kBatch], mx[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int64_t e = base + 32 * (i0 + i) + lane;
      gx[i] = e < n ? to_f32(g[e]) : 0.0f;
      mx[i] = e < n ? to_f32(m[e]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int64_t e = base + 32 * (i0 + i) + lane;
      bool bit = true;
      if (e < n) {
        const Mt v = Momentum<Mt>::step(b, mx[i], c, gx[i]);
        m_out[e] = v;
        bit = nonneg_stored(v);
      }
      const unsigned ballot = __ballot_sync(kFullWarp, bit);
      if (lane == i0 + i) word = ballot;
    }
  }
  return word;
}

// m_out may alias m. `vec`: g, m and m_out lie on 16-byte boundaries. A
// null `packed` (the same for every thread) writes m' only. Every branch
// below is the same for the whole warp, as the shuffles and ballots need.
template <typename G, typename Mt>
__global__ void __launch_bounds__(kThreads, MspLayout<G, Mt>::kBlocks)
momentum_sign_pack_kernel(const G* __restrict__ g, const Mt* m, Mt* m_out,
                          uint32_t* __restrict__ packed, int64_t n,
                          int64_t w, float b, float c, bool vec) {
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5) * kSegment;
  if (base >= n) return;
  uint32_t word;
  if (vec && base + kSegment <= n) {
    const uint32_t fields =
        msp_segment_vec<G, Mt>(g, m, m_out, base, lane, b, c);
    if (packed == nullptr) return;
    word = fields_to_word<MspLayout<G, Mt>::kE>(fields, lane);
  } else {
    word = msp_segment_elems<G, Mt>(g, m, m_out, n, base, lane, b, c);
    if (packed == nullptr) return;
  }
  const int64_t k = (base >> 5) + lane;
  if (k < w) packed[k] = word;
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
  if (n > 0) {
    const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
    const uintptr_t ma = reinterpret_cast<uintptr_t>(m);
    const uintptr_t oa = reinterpret_cast<uintptr_t>(m_out);
    const bool vec = ((ga | ma | oa) & 15) == 0;
    const int64_t segments = (n + kSegment - 1) / kSegment;
    momentum_sign_pack_kernel<G, Mt>
        <<<blocks_for(segments * 32), kThreads, 0, (cudaStream_t)stream>>>(
            (const G*)g, (const Mt*)m, (Mt*)m_out, (uint32_t*)packed, n,
            (n + 31) / 32, b, c, vec);
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
