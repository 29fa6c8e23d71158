// The server's tallies for Hopper (sm_90a): the vote over M packed voter
// rows on the 1-bit wire and on the ternary2bit codec's 2-bit wire.
//
// majority_packed replaces the Pallas kernel
//   src/repro/kernels/vote.py:37 majority_packed (pallas_call at :42)
// ternary_majority replaces
//   src/repro/kernels/ternary_pack.py:79 ternary_tally_packed (pallas_call at :84)
//
// majority_packed: (M, w) words -> (w,) words. Bit j of an output word is
//   set where 2 * count >= M, count being the voters whose bit j is set, so
//   ties go to +1 (the 1-bit wire's sign(0) = +1).
// ternary_majority: (M, w) words of 16 two-bit fields (field j in bits
//   2j..2j+1; +1 -> 0b01, -1 -> 0b11) -> (w,) words. Per field the +1 votes
//   against the -1 votes: 0b01 where there are more +1s, 0b11 where there
//   are more -1s, 0b00 on a tie, all-abstaining fields included. 0b00 and
//   the unused 0b10 count nothing, as the reference's where() decodes them.
// ternary_majority_plus_one: the same count with the tie rule of the
//   reference's hierarchical wire (src/repro/core/vote_engine.py:255-315:
//   the voters' ternary signs summed as counts, then sign_binary of the
//   count): 0b01 wherever the +1 votes are at least the -1 votes, ties and
//   all-abstaining fields included, else 0b11. It has no Pallas
//   counterpart; the trainer's hierarchical wire tallies with it.
// None has a cap on M.
//
// Bound on the H100 (3.35 TB/s): an output word reads M words and writes
// one, (M + 1) * 4 B, and the counting below takes a few word operations
// per voter, so device-memory bytes bound both. At the glm4-9b unembedding
// (n = 620,756,992) with M = 4: majority_packed 19,398,656 words, 0.39 GB,
// 0.116 ms; ternary_majority (either tie rule) 38,797,312 words, 0.78 GB,
// 0.232 ms.
//
// Design. The TPU kernels count each of the 32 bit positions (16 fields)
// of an (M, 512) VMEM block in turn. Carried over as one thread per output
// word with 32 (16) counters in registers, every voter word was shifted,
// masked and added into each counter: ~350 integer instructions per word
// at M = 4, so those kernels ran at the card's integer issue rate, a
// quarter of the byte bound. Here the counts are bit-sliced: P planes of
// 32 bits, P the bit length of M (M < 2^P), plane p holding bit p of the
// 32 counts of a word. A lane decoder gives the 32 bits of a voter's word
// that count: on the 1-bit wire the word itself; on the 2-bit wire a +1
// vote in the field's even bit and a -1 vote in its odd bit, so one set of
// planes counts both. Voters are added four at a time with carry-save
// full adders (three per four voters, two logic operations each) whose
// weight-4 carry ripples through the planes above, and the last M % 4 one
// at a time with a ripple of half-adders. A finisher compares the counts
// plane by plane, most significant first: against ceil(M / 2) on the
// 1-bit wire, the even count against the odd one on the 2-bit wire (two
// finishers: ties 0b00, or ties +1 for the hierarchical wire). All three
// tallies are this one template over the decoder and the finisher. Each P
// up to 8 (M <= 255) has a kernel of its own; one more kernel keeps
// kAnyPlanes = 31 planes, enough for any int M, and stops each ripple once
// its carry is zero. On M = 64 to 255 (P = 7, 8) it runs 18-35 % slower
// than their own kernels: its 31 x 4 counters take ~175 registers, one
// block an SM. At M = 4 an output word takes ~15 logic operations
// (~35 on the 2-bit wire, with the decode) instead of ~350.
// Memory: a thread owns kWords = 4 consecutive output words. For each voter
// row it issues one 16-byte load, the loads of up to kGroup = 8 rows before
// it counts any of them, and it writes its 4 words with one 16-byte store;
// neighbouring threads read neighbouring 16 bytes of every row. That path
// needs every row and out on a 16-byte boundary (packed and out aligned, w
// a multiple of 4). A misaligned view and the ragged tail take the word
// path of the same kernel: the same 4 words, loaded and stored one by one.
// Rejected, each timed on an H100 (PERF.md, Findings of PR 15): one thread
// per output word with a counter per bit or field (the kernels this
// replaces); the half-adder ripple alone (as fast up to M = 128, 2.9x
// slower on the 31-plane kernel at M = 1000); 4 rows loaded per group; a
// 64-register cap (local-memory spills); own kernels up to P = 10 (faster
// only for M of 256 to 1023, two more kernels per wire).
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;         // output words a thread owns: 16 bytes
constexpr int kGroup = 8;         // voter rows loaded before any is counted
constexpr int kAnyPlanes = 31;    // planes enough for any int M

// Lane decoders: the 32 bits of a voter's word that are counted.
struct SignLanes {      // the 1-bit wire: bit j is a vote for +1 at j
  static __device__ __forceinline__ uint32_t lanes(uint32_t u) { return u; }
};
struct TernaryLanes {   // the 2-bit wire: 01 -> even bit, 11 -> odd bit
  static __device__ __forceinline__ uint32_t lanes(uint32_t u) {
    const uint32_t lo = u & 0x55555555u;
    const uint32_t hi = (u >> 1) & 0x55555555u;
    return (lo & ~hi) | ((lo & hi) << 1);
  }
};

// Finishers: the output word from the planes c of one word's counts.
struct AtLeastHalf {    // bit j set where count_j >= need = ceil(M / 2)
  template <int P>
  static __device__ __forceinline__ uint32_t finish(const uint32_t (&c)[P],
                                                    uint32_t need) {
    uint32_t gt = 0, eq = 0xffffffffu;   // count above / equal to need so far
#pragma unroll
    for (int p = P - 1; p >= 0; --p) {
      if ((need >> p) & 1u) {            // the same in every thread
        eq &= c[p];
      } else {
        gt |= eq & c[p];
        eq &= ~c[p];
      }
    }
    return gt | eq;
  }
};
// Compares the count of +1 votes (the even bits of the planes) with the
// count of -1 votes (the odd bits) of each field, most significant plane
// first: the even bit j of gt (lt) is set where plus_j > minus_j (<).
template <int P>
__device__ __forceinline__ void compare_fields(const uint32_t (&c)[P],
                                               uint32_t& gt, uint32_t& lt) {
  gt = 0;
  lt = 0;
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {
    const uint32_t plus = c[p] & 0x55555555u;
    const uint32_t minus = (c[p] >> 1) & 0x55555555u;
    const uint32_t open = ~(gt | lt);
    gt |= open & plus & ~minus;
    lt |= open & minus & ~plus;
  }
}
struct Plurality {   // field j: 01 if plus_j > minus_j, 11 if below, else 00
  template <int P>
  static __device__ __forceinline__ uint32_t finish(const uint32_t (&c)[P],
                                                    uint32_t) {
    uint32_t gt, lt;
    compare_fields<P>(c, gt, lt);
    return gt | lt | (lt << 1);
  }
};
struct PluralityPlusOne {   // field j: 11 if plus_j < minus_j, else 01
  template <int P>
  static __device__ __forceinline__ uint32_t finish(const uint32_t (&c)[P],
                                                    uint32_t) {
    uint32_t gt, lt;
    compare_fields<P>(c, gt, lt);
    return 0x55555555u | (lt << 1);
  }
};

// Adds the 32 one-bit numbers of weight 2^From in `carry` to the planes c,
// a ripple of half-adders. With P below kAnyPlanes the carry out of the
// top plane is always 0 (M < 2^P); with kAnyPlanes the ripple stops once
// the carry is 0 in every lane.
template <int From, int P>
__device__ __forceinline__ void ripple(uint32_t (&c)[P], uint32_t carry) {
#pragma unroll
  for (int p = From; p < P; ++p) {
    const uint32_t t = c[p] & carry;
    c[p] ^= carry;
    carry = t;
    if (P == kAnyPlanes && carry == 0) break;
  }
}

// x + y + z = sum + 2 * carry, lane by lane: one full adder per lane, two
// three-input logic operations per word.
__device__ __forceinline__ uint32_t carry_save(uint32_t& x, uint32_t y,
                                               uint32_t z) {
  const uint32_t carry = (x & y) | (z & (x ^ y));
  x ^= y ^ z;
  return carry;
}

// Adds four voters' lane words: two full adders into plane 0, one into
// plane 1, and the carry of weight 4 rippled in from plane 2 (P >= 3, so
// M >= 4).
template <int P>
__device__ __forceinline__ void count_four(uint32_t (&c)[P], uint32_t a,
                                           uint32_t b, uint32_t d,
                                           uint32_t e) {
  if constexpr (P >= 3) {
    const uint32_t t = carry_save(c[0], a, b);
    const uint32_t u = carry_save(c[0], d, e);
    ripple<2>(c, carry_save(c[1], t, u));
  }
}

// `vec`: packed and out lie on 16-byte boundaries and w % kWords == 0.
template <typename Lanes, typename Finish, int P>
__global__ void __launch_bounds__(kThreads)
tally_kernel(const uint32_t* __restrict__ packed, uint32_t* __restrict__ out,
             int m, int64_t w, uint32_t need, bool vec) {
  const int64_t k0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kWords;
  if (k0 >= w) return;
  const bool whole = vec && k0 + kWords <= w;
  uint32_t c[kWords][P];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
#pragma unroll
    for (int p = 0; p < P; ++p) c[j][p] = 0;
  }
  for (int r0 = 0; r0 < m; r0 += kGroup) {
    uint32_t v[kGroup][kWords];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (r0 + i >= m) break;
      const uint32_t* row = packed + (int64_t)(r0 + i) * w + k0;
      if (whole) {
        const uint4 q = __ldcs(reinterpret_cast<const uint4*>(row));
        v[i][0] = q.x;
        v[i][1] = q.y;
        v[i][2] = q.z;
        v[i][3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < kWords; ++j)
          v[i][j] = k0 + j < w ? __ldcs(row + j) : 0u;
      }
    }
    // every index into v is a constant after unrolling, so v stays in
    // registers
#pragma unroll
    for (int i = 0; i < kGroup; i += 4) {
      if (r0 + i >= m) break;
      if (P >= 3 && r0 + i + 4 <= m) {
#pragma unroll
        for (int j = 0; j < kWords; ++j)
          count_four(c[j], Lanes::lanes(v[i][j]), Lanes::lanes(v[i + 1][j]),
                     Lanes::lanes(v[i + 2][j]), Lanes::lanes(v[i + 3][j]));
      } else {
#pragma unroll
        for (int e = i; e < i + 4; ++e) {
          if (r0 + e >= m) break;
#pragma unroll
          for (int j = 0; j < kWords; ++j)
            ripple<0>(c[j], Lanes::lanes(v[e][j]));
        }
      }
    }
  }
  uint32_t res[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    res[j] = Finish::template finish<P>(c[j], need);
  if (whole) {
    *reinterpret_cast<uint4*>(out + k0) =
        make_uint4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      if (k0 + j < w) out[k0 + j] = res[j];
  }
}

template <typename Lanes, typename Finish>
int tally(const void* packed, void* out, int m, int64_t w, void* stream) {
  if (m > 0 && w > 0) {
    using Kernel = void (*)(const uint32_t*, uint32_t*, int, int64_t,
                            uint32_t, bool);
    int planes = 0;                      // the bit length of m
    while (planes < kAnyPlanes && (m >> planes) != 0) ++planes;
    Kernel kernel;
    switch (planes) {
      case 1: kernel = tally_kernel<Lanes, Finish, 1>; break;
      case 2: kernel = tally_kernel<Lanes, Finish, 2>; break;
      case 3: kernel = tally_kernel<Lanes, Finish, 3>; break;
      case 4: kernel = tally_kernel<Lanes, Finish, 4>; break;
      case 5: kernel = tally_kernel<Lanes, Finish, 5>; break;
      case 6: kernel = tally_kernel<Lanes, Finish, 6>; break;
      case 7: kernel = tally_kernel<Lanes, Finish, 7>; break;
      case 8: kernel = tally_kernel<Lanes, Finish, 8>; break;
      default: kernel = tally_kernel<Lanes, Finish, kAnyPlanes>; break;
    }
    const uintptr_t bases = reinterpret_cast<uintptr_t>(packed) |
                            reinterpret_cast<uintptr_t>(out);
    const bool vec = (bases & 15) == 0 && w % kWords == 0;
    const int64_t threads = (w + kWords - 1) / kWords;
    const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
    const uint32_t need = (uint32_t)(m / 2 + m % 2);   // ceil(m / 2)
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)packed, (uint32_t*)out, m, w, need, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int majority_packed(const void* packed, void* out, int m, int64_t w,
                    void* stream) {
  return tally<SignLanes, AtLeastHalf>(packed, out, m, w, stream);
}

int ternary_majority(const void* packed, void* out, int m, int64_t w,
                     void* stream) {
  return tally<TernaryLanes, Plurality>(packed, out, m, w, stream);
}

int ternary_majority_plus_one(const void* packed, void* out, int m, int64_t w,
                              void* stream) {
  return tally<TernaryLanes, PluralityPlusOne>(packed, out, m, w, stream);
}

}  // extern "C"
