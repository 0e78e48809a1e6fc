// One work item of the grouped scorers on the tensor cores: the tile body
// shared by the int8 scorers, item-major (grouped_scorer_item.cu, K4) and
// slot-major (grouped_scorer.cu, K2), and by the bf16 / f32 scorer
// (grouped_scorer_f.cu, K6). They differ in the operand policy (the type
// of the queries and the mma that multiplies them) and in where they
// store the block.
//
//   s_out[m * kRows + r] = (acc(m, r) [+ qadd[m]]) * tile_scale[row0 + r]
//   acc(m, r) = sum_v q[m, v] * a(u8[row0 + r, v])
//
// with the f32 add and multiply rounded once each (__fadd_rn, __fmul_rn).
//
// Policies. MmaU8S8 (K4, K2): mma.sync.m16n8k32 with u8 A (16 tile rows x
// 32 bytes, a(x) = x) and s8 B (32 bytes x 8 query slots), int32
// accumulators: the dot is exact and needs neither a recentring of the u8
// codes nor a 128 * sum(q) correction. MmaBf16<kTerms> (K6):
// mma.sync.m16n8k16 with bf16 A, a(x) = x - off (off 128 in the centred
// form, 0 in the fixup form: an integer below 256, exact in bf16), and
// bf16 B, f32 accumulators. With kTerms = 1 B is the query rounded to bf16
// (nearest even); with kTerms = 3 it is the query split into three bf16
// terms, hi = bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid), whose
// sum is q exactly, each multiplied by the same A fragment. Every product
// of an integer below 256 and a bf16 value is exact in f32, so only the
// order of the f32 sum differs from a plain f32 product. Each k-slice's
// products are summed by the tensor cores in a fresh fragment and added to
// the running f32 sum with one rounded FADD, so the tensor cores' own
// accumulation, which need not round to nearest, never spans more than 64
// columns. The u8 -> bf16 conversion runs once per byte per block, in
// registers: __byte_perm puts the byte into the mantissa of 2^23, one FADD
// of -(2^23 + off) leaves the exact f32 value, whose upper half is its
// bf16 (the lower half is 0), and one __byte_perm packs two such halves.
//
// Layout. The block is 256 threads, 8 warps; warp w owns tile rows
// [w * RW, (w + 1) * RW), RW = kRows / 8 (16 a subtile: csub m16 tiles),
// and all kM query slots (kM / 8 n8 tiles). A warp streams its rows
// through a private ring of shared memory (kStages * 64 bytes a row),
// filled with 16-byte cp.async (L2 only, .cg) a stage at a time; a stage
// holds kSlicesPerStage k-slices of 64 bytes, each slice its RW rows at a
// 64-byte pitch, so the 8 lanes of one 16-byte shared load (two rows x
// four 16-byte columns) cover 128 distinct bytes, all 32 banks, with no
// swizzle (rows V bytes apart would put them all on one bank set). K4 and
// K2 take one slice a stage (4 stages); K6 takes two, so each fetch asks
// for 128 contiguous bytes of a row (2 stages): against 64-byte fetches
// that cut its time by a quarter on the card (PERF.md). The group's
// [kM, V] queries are staged once per block (once per V chunk past the
// instance's widest V) in the same k-slice order,
// kParts 64-byte rows a slot and a slice: s_q[ks][part][m][64 bytes], the
// same conflict-free pitch.
//
// Fragments. Lane (g = lane / 4, t = lane % 4) reads 16 bytes, at column
// t * 16 of its slice, of each of its rows g and g + 8, and the 16 bytes
// at t * 16 of each part of its query slots g (+ 8). The k order inside a
// slice is permuted the same way for A and B, so one 16-byte load of a row
// feeds several k steps and the sum is unchanged:
//   u8 x s8, k32 step s = 0, 1: logical k = 4t + j is byte t * 16 + 8s + j,
//     logical k = 16 + 4t + j byte t * 16 + 8s + 4 + j (j < 4);
//   bf16, k16 step s = 0..3: logical k = 2t + j is column t * 16 + 4s + j,
//     logical k = 8 + 2t + j column t * 16 + 4s + 2 + j (j < 2); the
//     queries' columns t * 16 + 8p .. + 7 (16 bytes of bf16) sit in part p
//     (p = 0, 1; parts 2, 3 and 4, 5 hold mid and lo) at byte t * 16.
//
// After the last slice every warp's ring is free: s_out (kM * kRows f32)
// aliases the start of shared memory. The function ends with
// __syncthreads().
//
// Shapes. An instance holds kM <= 32 query slots and kRows <= 512 rows
// (csub <= 4): its accumulators live in registers and its rings in 227 KB
// of shared memory beside the staged queries. JAX's kernel takes every
// M % 8 == 0, every csub and every V % 128 == 0 (pallas_grouped.py:76),
// and the scorers serve them with those instances:
// - V past what one instance's shared memory holds beside its rings
//   (mma_max_v): the ring streams the tile rows over all of V as before,
//   and at each kVMax columns the block stages the next chunk's [kM,
//   chunk] queries over the last (two barriers), its accumulators carried
//   on, so the int32 dots stay exact and the f32 sums keep their slice
//   order;
// - M past 32: the group's slots in chunks of 32 along the grid (y), and
//   one more launch for the rest (for_m_chunks); a chunk reads its rows of
//   the [M, V] queries and writes its own output rows;
// - csub past 4: the item's subtiles in parts of chunk_csub(csub)
//   subtiles (the largest divisor of csub up to 4), one launch a part, in
//   stream order; the packed epilogue then takes each window's max across
//   the parts as a running integer max (store_packed_part of
//   pack_epilogue.cuh).
// One V chunk, one M chunk and one part (a launch, no restaging) is the
// path of every shape up to M 32, csub 4 and the instance's widest V.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "opt_in.cuh"

constexpr int kMmaThreads = 256;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kSliceBytes = 64;  // bytes of a row one pipeline stage holds
constexpr int kStages = 4;       // ring depth of each warp
// V is a multiple of this: every policy streams whole 128-byte stages (K6
// two 64-byte slices a stage), and JAX's kernel asks V % 128 == 0
constexpr int kVAlign = 128;
constexpr int kSubRows = 128;  // rows of a subtile; an item holds csub
// The instances: kM query slots a multiple of 8 up to kChunkM, kRows =
// csub * 128 rows for csub up to kChunkCsub, each pair its own template
// instance; wider shapes run as chunks of these (see above).
constexpr int kChunkM = 32;
constexpr int kChunkCsub = 4;

// bytes of dynamic shared memory a block needs: the warps' rings, then
// the group's queries, q_bytes a query value
__host__ __device__ constexpr int mma_ring_smem(int m, int rows, int v,
                                                int q_bytes) {
  return kMmaWarps * kStages * (rows / kMmaWarps) * kSliceBytes +
         m * v * q_bytes;
}

// the widest V whose rings and [m, V] queries fit in kMaxSmemBytes: the
// widest V chunk of the instance (m, rows)
__host__ __device__ constexpr int mma_max_v(int m, int rows, int q_bytes) {
  return m <= 0 || rows <= 0
             ? 0
             : (kMaxSmemBytes - mma_ring_smem(0, rows, 0, 0)) /
                   (m * q_bytes) / kVAlign * kVAlign;
}

// the shared memory a launch of the instance (m, rows) sizes for V: the
// rings and one V chunk of queries
__host__ __device__ constexpr int mma_launch_smem(int m, int rows, int v,
                                                  int q_bytes) {
  return mma_ring_smem(m, rows,
                       v < mma_max_v(m, rows, q_bytes)
                           ? v
                           : mma_max_v(m, rows, q_bytes),
                       q_bytes);
}

// Blocks an SM the kernel of kM slots, kRows rows and operand policy Op is
// compiled for (its __launch_bounds__): 2, so at most 128 registers a
// thread, or 1, so up to 255, by the policy's min_blocks of the registers
// that grow with the shape: a warp's MT x NT accumulator fragments and its
// NT x kParts query fragments, 4 each. Every shape up to M 16 and csub 2
// takes 2 in both policies. Rings over half of the shared memory (csub 4:
// 128 KB) leave one block an SM whatever the registers, so those take 1.
template <int kM, int kRows, class Op>
struct MmaMinBlocks {
  static constexpr int kAcc = (kRows / kSubRows) * (kM / 8) * 4;
  static constexpr int kQFrag = (kM / 8) * Op::kParts * 4;
  static constexpr int value =
      2 * mma_ring_smem(0, kRows, 0, 0) > kMaxSmemBytes
          ? 1
          : Op::min_blocks(kAcc, kQFrag);
};

// JAX's shape rule (pallas_grouped.py:76): M % 8 == 0, V % 128 == 0;
// csub >= 1 (ll_max % (csub * 128) == 0 is the caller's)
__host__ __device__ constexpr bool mma_shape_ok(int m, int csub, int v) {
  return m % 8 == 0 && m >= 0 && csub >= 1 && v % kVAlign == 0 && v >= 0;
}

// the subtiles of one part of an item of csub subtiles: the largest
// divisor of csub up to kChunkCsub
__host__ __device__ constexpr int chunk_csub(int csub) {
  return csub % 4 == 0 ? 4 : csub % 3 == 0 ? 3 : csub % 2 == 0 ? 2 : 1;
}

// the query slots of the instance that serves M (its first chunk)
__host__ __device__ constexpr int chunk_m(int m) {
  return m < kChunkM ? m : kChunkM;
}

// the widest V chunk of the instance that serves (M, csub) at q_bytes a
// query value (0 for a shape past JAX's rule)
__host__ __device__ constexpr int mma_chunk_v(int m, int csub,
                                              int q_bytes) {
  return mma_shape_ok(m, csub, 0) && m > 0
             ? mma_max_v(chunk_m(m), chunk_csub(csub) * kSubRows, q_bytes)
             : 0;
}

// f(km, m_base, n_y) for each launch of M slots: chunks of kChunkM slots
// along the grid's y (n_y of them from slot 0), then one launch of the
// M % kChunkM left (from slot m_base); nothing for M = 0. Returns the
// first error.
template <class F>
int for_m_chunks(int M, F&& f) {
  const int n32 = M / kChunkM, rest = M % kChunkM;
  int rc = n32 > 0 ? f(kChunkM, 0, n32) : 0;
  if (rc == 0 && rest > 0) rc = f(rest, n32 * kChunkM, 1);
  return rc;
}

// f(integral_constant<kM>, integral_constant<kRows>) at the pair (M, csub)
// (kRows = csub * 128), the launch of that pair's instance; an error code
// for a pair past the instances.
template <int kM, class F>
int dispatch_csub(int csub, F& f) {
  using M = std::integral_constant<int, kM>;
  switch (csub) {
    case 1: return f(M{}, std::integral_constant<int, kSubRows>{});
    case 2: return f(M{}, std::integral_constant<int, 2 * kSubRows>{});
    case 3: return f(M{}, std::integral_constant<int, 3 * kSubRows>{});
    case 4: return f(M{}, std::integral_constant<int, 4 * kSubRows>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class F>
int dispatch_shape(int M, int csub, F&& f) {
  static_assert(kChunkM == 32 && kChunkCsub == 4, "the cases below");
  switch (M) {
    case 8: return dispatch_csub<8>(csub, f);
    case 16: return dispatch_csub<16>(csub, f);
    case 24: return dispatch_csub<24>(csub, f);
    case 32: return dispatch_csub<32>(csub, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += A (u8, 16 x 32, row) * B (s8, 32 x 8, col), exact int32
__device__ __forceinline__ void mma_u8s8(int (&d)[4], int a0, int a1, int a2,
                                         int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A (bf16, 16 x 16, row) * B (bf16, 16 x 8, col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// component i of v (i a compile-time constant after unrolling)
__device__ __forceinline__ unsigned int4_word(const int4& v, int i) {
  const int x = i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  return static_cast<unsigned>(x);
}

// ---- operand policies ----

// int8 queries, u8 x s8 -> exact int32 (K4, K2)
struct MmaU8S8 {
  using Q = int8_t;                 // a query value in device memory
  // 64-byte rows a slot and a k-slice, so also bytes a query value
  static constexpr int kParts = 1;
  static constexpr int kSlicesPerStage = 1;
  using Acc = int;

  // no spill at 2 blocks an SM up to 64 such registers (ptxas: M 32 x
  // csub 3, at 64, takes 110 registers)
  static constexpr int min_blocks(int acc, int qfrag) {
    return acc + qfrag <= 64 ? 2 : 1;
  }

  // s_q[ks][m][64] <- qg[m * ld + ks * 64 .. + 64), ks < vc / 64; m * ld
  // in 32 bits (kM * V < 2^31): with a 64-bit product the headline's V 512
  // instance read 0.9% slower (PERF.md §6)
  template <int kM>
  __device__ __forceinline__ void stage(const int8_t* __restrict__ qg,
                                        int ld, uint8_t* s_q, int vc) const {
    for (int i = threadIdx.x; i < kM * vc / 16; i += kMmaThreads) {
      const int m = i / (vc / 16);
      const int c = i % (vc / 16);
      *reinterpret_cast<int4*>(s_q + (c >> 2) * (kM * kSliceBytes) +
                               m * kSliceBytes + (c & 3) * 16) =
          reinterpret_cast<const int4*>(qg + m * ld)[c];
    }
  }

  // the lane's 16 bytes of rows g (lo) and g + 8 (hi): two k32 steps
  __device__ __forceinline__ void mma(int (&d)[4], const int4& lo,
                                      const int4& hi, const int4* b) const {
    mma_u8s8(d, lo.x, hi.x, lo.y, hi.y, b[0].x, b[0].y);
    mma_u8s8(d, lo.z, hi.z, lo.w, hi.w, b[0].z, b[0].w);
  }

};

// f32 queries as kTerms bf16 terms (1: rounded; 3: split exactly), u8 - off
// x bf16 -> f32 (K6)
template <int kTerms>
struct MmaBf16 {
  using Q = float;
  static constexpr int kParts = 2 * kTerms;
  static constexpr int kSlicesPerStage = 2;
  using Acc = float;
  float sub;  // 2^23 + off

  // each accumulator register costs about two (its slice's fresh fragment
  // and the conversions): ptxas spilled at 128 registers from M 16 x csub 4
  // and M 32 x csub 2 in bf16 mode, and not below 2 * acc + qfrag / 2 = 64
  static constexpr int min_blocks(int acc, int qfrag) {
    return 2 * acc + qfrag / 2 <= 64 ? 2 : 1;
  }

  // bytes j, j + 1 of w, each less off, as a bf16x2 (byte j low)
  template <int J>
  __device__ __forceinline__ unsigned a_pair(unsigned w) const {
    const float f0 = __fsub_rn(
        __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | J)), sub);
    const float f1 = __fsub_rn(
        __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | (J + 1))), sub);
    return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  }

  // s_q[ks][term * 2 + p][m][t * 16 ..] <- the bf16 terms of
  // qg[m * ld + ks * 64 + t * 16 + 8p .. + 8), ks < vc / 64
  template <int kM>
  __device__ __forceinline__ void stage(const float* __restrict__ qg, int ld,
                                        uint8_t* s_q, int vc) const {
    for (int i = threadIdx.x; i < kM * vc / 8; i += kMmaThreads) {
      const int m = i / (vc / 8);
      const int c = i % (vc / 8);  // 8-value chunk of the row
      const float4* src = reinterpret_cast<const float4*>(qg + m * ld) + 2 * c;
      const float4 x = src[0], y = src[1];
      float r[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
      uint8_t* dst = s_q + (c >> 3) * (kParts * kM * kSliceBytes) +
                     (c & 1) * (kM * kSliceBytes) + m * kSliceBytes +
                     ((c >> 1) & 3) * 16;
#pragma unroll
      for (int term = 0; term < kTerms; ++term) {
        unsigned w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(r[2 * j],
                                                         r[2 * j + 1]);
          w[j] = *reinterpret_cast<const unsigned*>(&h);
          // the remainder, exact in f32, for the next term
          r[2 * j] = __fsub_rn(r[2 * j], __low2float(h));
          r[2 * j + 1] = __fsub_rn(r[2 * j + 1], __high2float(h));
        }
        *reinterpret_cast<uint4*>(dst + term * 2 * (kM * kSliceBytes)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  // the lane's 16 bytes of rows g (lo) and g + 8 (hi): four k16 steps, each
  // against every term (b[term * 2 + p] holds steps 2p and 2p + 1), summed
  // in a fresh fragment that one rounded FADD adds to d: the tensor cores'
  // own f32 accumulation then spans one slice, not the whole row
  __device__ __forceinline__ void mma(float (&d)[4], const int4& lo,
                                      const int4& hi, const int4* b) const {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned wl = int4_word(lo, s), wh = int4_word(hi, s);
      const unsigned a0 = a_pair<0>(wl), a2 = a_pair<2>(wl);
      const unsigned a1 = a_pair<0>(wh), a3 = a_pair<2>(wh);
#pragma unroll
      for (int term = kTerms - 1; term >= 0; --term) {
        const int4& bt = b[term * 2 + (s >> 1)];
        mma_bf16(part, a0, a1, a2, a3, int4_word(bt, (s & 1) * 2),
                 int4_word(bt, (s & 1) * 2 + 1));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(d[i], part[i]);
  }
};

// ---- the tile body ----

// The warp's ring stages [k0, k1) of NS (stage ks in ring slot ks %
// kRing, the next stages' loads issued as it goes) multiplied into acc
// against the staged queries of the V chunk that starts at stage q0.
template <int kM, int kRows, class Op, class Load>
__device__ __forceinline__ void ring_stages(
    const Op& op, const Load& load_stage,
    typename Op::Acc (&acc)[kRows / kMmaWarps / 16][kM / 8][4],
    const uint8_t* ring, const uint8_t* s_q, int NS, int k0, int k1,
    int q0) {
  constexpr int MT = kRows / kMmaWarps / 16;
  constexpr int NT = kM / 8;
  constexpr int kP = Op::kParts;
  constexpr int kSS = Op::kSlicesPerStage;
  constexpr int kRing = kStages / kSS;
  constexpr int kSliceRows = kRows / kMmaWarps * kSliceBytes;
  constexpr int kStageBytes = kSS * kSliceRows;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll 1
  for (int ks = k0; ks < k1; ++ks) {
    if (ks + kRing - 1 < NS) load_stage(ks + kRing - 1);
    cp_async_commit();           // (empty past the last stage)
    cp_async_wait<kRing - 1>();  // this lane's copies of stage ks landed
    __syncwarp();                // ... and every lane's
    // kept rolled: unrolled, both slices' B fragments stay live and the
    // f32 policy spills
#pragma unroll 1
    for (int h = 0; h < kSS; ++h) {
      const uint8_t* st = ring + (ks % kRing) * kStageBytes + h * kSliceRows;
      const uint8_t* sq =
          s_q + ((ks - q0) * kSS + h) * (kP * kM * kSliceBytes);
      int4 b[NT][kP];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          b[n][p] = *reinterpret_cast<const int4*>(
              sq + (p * kM + n * 8 + g) * kSliceBytes + t * 16);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int4 lo = *reinterpret_cast<const int4*>(
            st + (mt * 16 + g) * kSliceBytes + t * 16);
        const int4 hi = *reinterpret_cast<const int4*>(
            st + (mt * 16 + g + 8) * kSliceBytes + t * 16);
#pragma unroll
        for (int n = 0; n < NT; ++n) op.mma(acc[mt][n], lo, hi, b[n]);
      }
    }
    __syncwarp();  // the next iteration refills this stage
  }
}

template <int kM, int kRows, class Op>
__device__ __forceinline__ void score_item_ring(
    const Op& op,
    const uint8_t* __restrict__ tiles,     // [rows, V]
    const float* __restrict__ tile_scale,  // [rows]
    const typename Op::Q* __restrict__ qg,  // [kM, V], the group's queries
    const float* __restrict__ qadd,        // [kM] or null
    int V, int64_t row0, uint8_t* smem,    // dynamic shared memory
    float* s_out) {                        // [kM * kRows], aliases smem
  constexpr int RW = kRows / kMmaWarps;  // rows of one warp
  constexpr int MT = RW / 16;            // its m16 tiles
  constexpr int NT = kM / 8;             // n8 tiles of query slots
  constexpr int kP = Op::kParts;
  constexpr int kSS = Op::kSlicesPerStage;   // k-slices a ring stage holds
  constexpr int kRing = kStages / kSS;       // ring stages
  constexpr int kSliceRows = RW * kSliceBytes;  // one slice of the rows
  constexpr int kStageBytes = kSS * kSliceRows;
  constexpr int kCopies = kStageBytes / 16 / 32;  // cp.async a lane a stage
  // the widest V chunk: its [kM, chunk] queries beside the rings
  constexpr int kVMax = mma_max_v(kM, kRows, kP);
  static_assert(MT >= 1 && NT >= 1 && kCopies >= 1 && kRing >= 2, "shape");
  static_assert(kM * kRows * 4 <= kMmaWarps * kRing * kStageBytes,
                "s_out must fit in the rings");
  static_assert(kVMax >= kVAlign, "one V chunk must fit");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint8_t* ring = smem + warp * (kRing * kStageBytes);
  uint8_t* s_q = smem + kMmaWarps * kRing * kStageBytes;
  const uint8_t* wrows = tiles + (row0 + warp * RW) * V;

  // ring stages to stream over all of V: V is a multiple of kVAlign, so
  // whole stages; at V 128 that is 2 (K4, K2) or 1 (K6), under the ring's
  // depth, and the prologue loads only those while still committing one
  // group a stage, so the wait counts below hold for any NS >= 1
  const int NS = V / (kSS * kSliceBytes);
  // the stages one chunk of staged queries covers: past them (V wider
  // than kVMax) the block stages the next chunk's queries over the last
  constexpr int kChunkStages = kVMax / (kSS * kSliceBytes);

  // stage ks % kRing <- rows' bytes [ks * kSS * 64, + kSS * 64): chunk i =
  // row i / (4 kSS), 16-byte column c = i % (4 kSS), lands in slice c / 4
  // of the stage at row * 64 + (c % 4) * 16
  auto load_stage = [&](int ks) {
    const unsigned st = smem_addr(ring + (ks % kRing) * kStageBytes);
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int i = lane + 32 * j;
      const int row = i / (4 * kSS), c = i % (4 * kSS);
      cp_async16(st + (c >> 2) * kSliceRows + row * kSliceBytes + (c & 3) * 16,
                 wrows + row * V + ks * (kSS * kSliceBytes) + c * 16);
    }
  };
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < NS) load_stage(s);
    cp_async_commit();
  }

  op.template stage<kM>(qg, V, s_q, V < kVMax ? V : kVMax);
  float scale[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int64_t r = row0 + warp * RW + mt * 16 + g;
    scale[mt][0] = tile_scale[r];
    scale[mt][1] = tile_scale[r + 8];
  }
  float add[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    add[n][0] = qadd ? qadd[n * 8 + 2 * t] : 0.0f;
    add[n][1] = qadd ? qadd[n * 8 + 2 * t + 1] : 0.0f;
  }
  __syncthreads();

  typename Op::Acc acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0;
    }
  }

  if (NS <= kChunkStages) {
    // one V chunk (every shape up to the instance's widest V, and at
    // compile time in an instance of one V): the queries staged once
    ring_stages<kM, kRows>(op, load_stage, acc, ring, s_q, NS, 0, NS, 0);
  } else {
    // the stages in chunks of kChunkStages, one chunk of staged queries
    // each: the next chunk's queries once every warp is done with the
    // last chunk's (the accumulators carry on)
#pragma unroll 1
    for (int kc = 0; kc < NS; kc += kChunkStages) {
      if (kc > 0) {
        const int v0 = kc * (kSS * kSliceBytes);
        __syncthreads();
        op.template stage<kM>(qg + v0, V, s_q,
                              V - v0 < kVMax ? V - v0 : kVMax);
        __syncthreads();
      }
      ring_stages<kM, kRows>(op, load_stage, acc, ring, s_q, NS, kc,
                             NS - kc < kChunkStages ? NS : kc + kChunkStages,
                             kc);
    }
  }

  // D fragment: acc[.][n][i] is row g + 8 * (i / 2), slot n * 8 + 2t + i % 2
  __syncthreads();  // every warp is done with the rings s_out overwrites
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = warp * RW + mt * 16 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int m = n * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = static_cast<float>(acc[mt][n][i]);
        if (qadd) v = __fadd_rn(v, add[n][i & 1]);
        s_out[(m + (i & 1)) * kRows + r + 8 * (i >> 1)] =
            __fmul_rn(v, scale[mt][i >> 1]);
      }
    }
  }
  __syncthreads();
}

// the int8 scorers' entry (K4, K2): no additive term; V at run time
template <int kM, int kRows>
__device__ __forceinline__ void score_item_mma(
    const uint8_t* __restrict__ tiles, const float* __restrict__ tile_scale,
    const int8_t* __restrict__ qg, int V, int64_t row0, uint8_t* smem,
    float* s_out) {
  score_item_ring<kM, kRows>(MmaU8S8{}, tiles, tile_scale, qg, nullptr, V,
                             row0, smem, s_out);
}
