// Exact candidate rescoring from fused forward-index rows, gather fused.
//
// Replaces: seismic_tpu/ops/pallas_rescore.py::score_docs_rowmajor_pallas
// (the pallas_call at :62) together with the forward-row gather and f32
// decode that its wrapper rescore_exact ran in XLA before it
// (pallas_rescore.py:119-159, the fwd_fused branch).
//
// For each query b and candidate r, with d = clamp(doc_ids[b, r], 0,
// n_docs - 1), comps = fwd[d, :W] and vals = f32 bits of fwd[d, W:]:
//   score[b, r] = sum_w val_w * sum_i qv[b, i] * [comps_w == qc[b, i]]
// where val_w = 0 at padding slots (comps_w == PAD_COMPONENT). The inner
// sum runs in term order from 0.0f, as pallas_rescore.py:54-56 adds it.
//
// Bound on an H100: bytes, the real entries (4-byte id, 4-byte value) of
// the candidates' forward rows at 3.35 TB/s. A compare of every entry with
// every query term (R * nnz * n_terms compare-adds, 8-10x the byte time
// at chip_smoke's shapes) is above that bound; a lookup does one probe an
// entry.
//
// Design: one 256-thread block per query. Warp 0 stages the query's real
// terms by ballot compaction (qloc_common.cuh), and the block enters them
// into K1's shared-memory hash table (term_table.cuh), which holds each
// id's values summed in term order: one lookup then gives an entry's
// inner sum bit for bit. A query of more than the static table's 256
// terms takes an instance of its own (kBig) whose table is sized to the
// row at run time in dynamic shared memory, as K1's (term_bits /
// term_smem of term_table.cuh: 2^bits slots at a load factor <= 1/2, up
// to 8192 terms in 192 KB); only past those does it walk its terms in
// device memory (term_walk), with the same sums. A warp takes one
// candidate row at a time and
// reads its ids in chunks of 64 (8 bytes a lane): the first two chunks at
// once, then one chunk at a time while the last one was full. A row's
// padding sits at its end, so a chunk with a PAD id ends the row (found
// by ballot), and an all-PAD row costs one chunk. A lane looks its ids up
// (the first probes of all of them issued together; the warp walks on
// only where some probe hit another id) and reads the value bits of its 2
// entries only where one of them hits, so a value sector that no query
// term touches is never read. The loads overlap: a row's doc id is read
// one row ahead, its first chunks before the previous row's sum reduces,
// and the warp's first row while the block builds its table. Rows are
// gathers of ~1 KB at random places, so the design buys loads in flight
// with warps: 8 blocks (64 warps) an SM, where warps holding 4 rows each
// fit 3 and ran slower on the H100 (PERF.md §6). The row's sum reduces
// over the warp in 5 shuffles. The [B*R, 2W] gathered copy of the TPU
// version never exists.
//
// The lean form (rescore_lean_kernel, entry point seismic_rescore_lean):
// the same computation over a document's ids (int16, -1 padded, or int32,
// PAD padded, past dim 32766), its u8 or u16 codes and its f32 (min,
// step), val_w = code_w * step + min, read by the JAX package as the i16
// twin (or the int32 ids) plus the codes decoded per document
// (pallas_rescore.py:147-159, search/engine.py:114-131). At int16 ids and
// u8 codes it reads 3W + 8 bytes a candidate row where the fused form
// reads 8W; u16 codes add W, int32 ids 2W. The half-width fused rows
// (entry point seismic_rescore_fused16, the JAX package's fwd_fused16,
// search/engine.py:190-203) are the same body: a row of W int32 words,
// id = word >> 16, value = the f16 bits of the low half, 4W bytes a row.
// The form is a policy of the one kernel template (Form below): ids and
// value bits are split into the same register layout, so the filter, the
// table, the skip and the row loop are shared, and only the decode
// differs: code * step + min, or the f16 widened (exact).
//
// On the block-pool route (FormU8) the rows are mostly L2 hits (77 MB of rows at the 100K cell, each
// read about 30 times a batch), so the bytes do not bound it: with every
// id on one document (the row L1-resident) it took as long as on the
// batch's own ids (chip_smoke phase 9 on an NVIDIA H100 80GB HBM3 at
// 700.00 W; PERF.md §6). Instructions issued a row do, so the design
// spends as few as it can on each entry and each row:
// - skip: with `skip` set, a doc id outside [0, n_docs) scores -inf and
//   its row is never read or visited (the block-pool tail masks those
//   slots anyway: 42% of them at the 100K cell); without it ids clamp,
//   as in JAX. A warp reads the doc ids of 32 of its row slots at once
//   and takes the rows to read from their ballot.
// - filter: beside K3's table the block builds a bitmap of the query's
//   terms over every uint16 (term_filter.cuh, 8 KB): an entry costs one
//   shared load and a rotate, a -1 id tests a clear bit, and only the
//   ~3% that hit probe the table.
// - one round trip a row: a lane issues its 8 ids (one 16-byte load), its
//   8 codes (one 8-byte load) and the row's (min, step) together,
//   unconditionally, when W % 8 == 0 and the bases are aligned (8 single
//   loads of each otherwise), and W = 256 is one span. A longer row takes
//   a span at a time while the last span held no -1.
// - rows in flight: a warp loads its next row before this row's sum
//   reduces; 4 blocks an SM leave 64 registers a thread (no spill), 3
//   blocks 80 for the other forms' 4 value words or 8 id words a part.
// The decode keeps the rounding of two separate f32 ops (no FMA).

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "qloc_common.cuh"
#include "term_filter.cuh"
#include "term_table.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // ids a warp reads at once, 2 a lane
constexpr int kPad = kQlocPad;

// the words of p at columns w and w + 1 (w even, w < W; `fill` past W):
// one 8-byte load when W is even (p + w is then 8-byte aligned), else two
__device__ __forceinline__ int2 load2(const int* p, int w, int W, int fill) {
  if ((W & 1) == 0) return __ldg(reinterpret_cast<const int2*>(p + w));
  return make_int2(__ldg(p + w), w + 1 < W ? __ldg(p + w + 1) : fill);
}

// the ids of chunk `ch` of row `row` into c[0..1] (PAD past W)
__device__ __forceinline__ void load_ids(const int* row, int ch, int W,
                                         int* c) {
  const int w = ch * kChunk + 2 * (threadIdx.x & 31);
  const int2 x = w < W ? load2(row, w, W, kPad) : make_int2(kPad, kPad);
  c[0] = x.x;
  c[1] = x.y;
}

// Start a row: the fused row of doc d (clamped) and the ids of its first
// two chunks in c.
__device__ __forceinline__ const int* start_row(const int* fwd, int d,
                                                int n_docs, int W,
                                                int (&c)[4]) {
  d = d < 0 ? 0 : (d > n_docs - 1 ? n_docs - 1 : d);
  const int* row = fwd + static_cast<int64_t>(d) * (2 * W);
  load_ids(row, 0, W, c);
  load_ids(row, 1, W, c + 2);
  return row;
}

// A block's query terms: its row b of SC terms (the kernel's operands).
// kBig false (SC <= kTermStaticTerms): the block's static 512-slot table
// and staged terms, a compile-time hash. kBig: a table of term_bits(SC)
// bits at the start of dynamic shared memory, the staged terms after it
// (term_smem(SC) bytes), or past kTableMaxTerms no table (bits 0) and the
// row walked in device memory (term_walk), with the same sums. The build
// ends on a barrier.
template <bool kBig>
struct Terms {
  const int* qc;    // [B, SC]
  const float* qv;  // [B, SC]
  int SC;
  int bits;         // the table's; 0: walked
  int2* tab;        // (term id, f32 value bits)
  int* s_qc;
  float* s_qv;

  __device__ __forceinline__ Terms(const int* qc_, const float* qv_, int SC_,
                                   int2* s_tab1, int* s_qc1, float* s_qv1,
                                   int2* s_dyn)
      : qc(qc_), qv(qv_), SC(SC_) {
    if constexpr (kBig) {
      bits = SC > kTableMaxTerms ? 0 : term_bits(SC);
      tab = s_dyn;
      s_qc = reinterpret_cast<int*>(s_dyn + (1 << bits));
      s_qv = reinterpret_cast<float*>(s_qc + SC);
    } else {
      bits = kTermBits;
      tab = s_tab1;
      s_qc = s_qc1;
      s_qv = s_qv1;
    }
  }
  __device__ __forceinline__ bool walk() const { return kBig && bits == 0; }
  __device__ __forceinline__ float walk_value(int c) const {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * SC;
    return term_walk(qc + row, qv + row, SC, c);
  }
  // stage and enter row b's real terms (table path), or only wait (walk)
  __device__ __forceinline__ void build(int* s_n, int* s_dup) const {
    if (walk()) {
      __syncthreads();
      return;
    }
    term_table_clear(tab, s_dup, bits);
    stage_terms(qc, qv, blockIdx.x, SC, s_qc, s_qv, s_n);
    __syncthreads();
    term_table_build(tab, s_qc, s_qv, *s_n, s_dup, bits);
  }
};

// The block's static term arrays: the static table's, or one element each
// where kBig keeps its table in dynamic shared memory.
#define K3_TERM_SMEM(kBig)                                   \
  __shared__ int s_qc1[(kBig) ? 1 : kTermStaticTerms];       \
  __shared__ float s_qv1[(kBig) ? 1 : kTermStaticTerms];     \
  __shared__ int2 s_tab1[(kBig) ? 1 : kTermSlots];           \
  extern __shared__ __align__(16) int2 s_dyn[];              \
  __shared__ int s_n;                                        \
  __shared__ int s_dup

// Blocks an SM of the kBig instances: their table's bits and pointers
// take registers that the static table's compile-time hash does not
constexpr int kBigFusedBlocks = 4;
constexpr int kBigLeanBlocks = 2;

template <bool kBig>
__global__ void __launch_bounds__(kThreads, kBig ? kBigFusedBlocks : 8)
rescore_fused_kernel(const int* __restrict__ fwd,      // [n_docs, 2W]
                     const int* __restrict__ doc_ids,  // [B, R]
                     const int* __restrict__ qc,       // [B, SC]
                     const float* __restrict__ qv,     // [B, SC]
                     int n_docs, int W, int R, int SC,
                     float* __restrict__ out) {        // [B, R]
  K3_TERM_SMEM(kBig);

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int* ids_b = doc_ids + static_cast<int64_t>(b) * R;

  // the warp's first row is in flight while the block builds the table
  int r = threadIdx.x >> 5;
  int c[4] = {kPad, kPad, kPad, kPad};  // [chunk][2] ids
  const int* row = r < R ? start_row(fwd, __ldg(ids_b + r), n_docs, W, c)
                         : fwd;
  const Terms<kBig> terms(qc, qv, SC, s_tab1, s_qc1, s_qv1, s_dyn);
  terms.build(&s_n, &s_dup);

  for (; r < R; r += kWarps) {
    const int d_next = r + kWarps < R ? __ldg(ids_b + r + kWarps) : 0;
    float part = 0.0f;
    int c0 = 0;
    int step = 2;  // chunks in c this round
    while (true) {
      float a[4];
      if (terms.walk()) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = terms.walk_value(c[j]);
      } else {
        term_find_n(terms.tab, c, a, terms.bits);
      }
      // the value bits where a term hits, both loads issued before a use
      int2 v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int w = (c0 + k) * kChunk + 2 * lane;
        v[k] = a[2 * k] != 0.0f || a[2 * k + 1] != 0.0f
                   ? load2(row + W, w, W, 0)
                   : make_int2(0, 0);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        part += __fmul_rn(__int_as_float(v[k].x), a[2 * k]);
        part += __fmul_rn(__int_as_float(v[k].y), a[2 * k + 1]);
      }
      // the row goes on only while the last chunk it read held no padding
      const int k = step - 1;
      const bool full = __ballot_sync(0xffffffffu, c[2 * k] == kPad ||
                                                       c[2 * k + 1] ==
                                                           kPad) == 0u;
      c0 += step;
      if (!full || c0 * kChunk >= W) break;
      load_ids(row, c0, W, c);
      c[2] = c[3] = kPad;
      step = 1;
    }
    // the next row's first chunks start loading before this sum reduces
    if (r + kWarps < R) row = start_row(fwd, d_next, n_docs, W, c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    if (lane == 0) out[static_cast<int64_t>(b) * R + r] = part;
  }
}

// K3's lean and half-width forms, one kernel body (rescore_lean_kernel)
// with the row's form as a policy. A lane takes 8 entries of a row span
// of kSpanU8: ids in F::kIdWords words (int16 pairs, or one int32 id a
// word in the wide forms), their values' bits in F::kValWords words (4
// u8 codes, or 2 u16 codes / f16 values a word). The forms:
//   FormU8   int16 ids, u8 codes, per-doc (min, step)     (PR 13's form)
//   FormU16  int16 ids, u16 codes, per-doc (min, step)
//   FormU8W  int32 ids, u8 codes, per-doc (min, step)    (dim > 32766)
//   FormU16W int32 ids, u16 codes, per-doc (min, step)   (dim > 32766)
//   FormF16  the half-width fused rows: one int32 word an entry, (id
//            int16 << 16) | f16 bits, no (min, step); a load of 8 words
//            is split into the int16 ids and the f16 bits by byte
//            permutes, so the body is FormU16's with another decode.
// The int16 forms test ids in the filter's bitmap of every uint16, which
// proves the id is a term (the table probe ends on it). int32 ids test
// the bit of their low 16 bits: a set bit no longer proves the id is a
// term, so the wide forms' probe may end on an empty slot and give 0
// (term_find_or_zero); a padding id (PAD_COMPONENT) passes only when a
// term shares its low bits, and then finds the empty key and gives 0. The
// alternative, no filter, would probe every entry; at the 3% hit rate of
// the int16 forms the filter keeps 32x fewer probes.
constexpr int kSpanU8 = 256;  // entries of a row a warp reads at once
constexpr int kSpanGroup = 32;  // row slots a warp reads the doc ids of at once
constexpr unsigned kNegInfBits = 0xff800000u;  // -inf

enum class Val { kU8, kU16, kF16 };

template <bool kWideIds, Val kV, int kBlocksSM>
struct Form {
  static constexpr bool kWide = kWideIds;
  static constexpr Val kVal = kV;
  static constexpr int kIdWords = kWideIds ? 8 : 4;
  static constexpr int kValWords = kV == Val::kU8 ? 2 : 4;
  // blocks an SM: FormU8 keeps <= 64 registers a thread; the forms with
  // 4 value words or 8 id words a part take <= 80
  static constexpr int kBlocks = kBlocksSM;
};
using FormU8 = Form<false, Val::kU8, 4>;
using FormU16 = Form<false, Val::kU16, 3>;
using FormU8W = Form<true, Val::kU8, 3>;
using FormU16W = Form<true, Val::kU16, 3>;
using FormF16 = Form<false, Val::kF16, 3>;

template <class F>
struct Part {
  unsigned id[F::kIdWords];   // padding: -1 int16 halves, or kPad
  unsigned val[F::kValWords];  // the ids' code / f16 bits
  float mn, st;                // the row's min and step (not FormF16)
};

// word j of 2, 4 or 8 by selects: no register array is indexed at run time
__device__ __forceinline__ unsigned sel2(const unsigned (&w)[2], int j) {
  return (j & 1) ? w[1] : w[0];
}
__device__ __forceinline__ unsigned sel4(const unsigned (&w)[4], int j) {
  const unsigned lo = (j & 1) ? w[1] : w[0];
  const unsigned hi = (j & 1) ? w[3] : w[2];
  return (j & 2) ? hi : lo;
}
__device__ __forceinline__ unsigned sel8(const unsigned (&w)[8], int j) {
  const unsigned a = (j & 1) ? w[1] : w[0];
  const unsigned b = (j & 1) ? w[3] : w[2];
  const unsigned c = (j & 1) ? w[5] : w[4];
  const unsigned d = (j & 1) ? w[7] : w[6];
  const unsigned lo = (j & 2) ? b : a;
  const unsigned hi = (j & 2) ? d : c;
  return (j & 4) ? hi : lo;
}

__device__ __forceinline__ uint4 ldg4(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// This lane's 8 entries of span w0 of doc d's row (0 <= d < n_docs): ids,
// value bits and the row's (min, step), all issued together. kVec: one
// 16-byte load of int16 ids (two of int32 ids or fused words) and one 8-
// or 16-byte load of codes, when W % 8 == 0 and the bases are aligned;
// else 8 single loads of each.
template <class F, bool kVec>
__device__ __forceinline__ Part<F> load_part(const void* __restrict__ ids,
                                             const void* __restrict__ codes,
                                             const float* __restrict__ vmin,
                                             const float* __restrict__ vstep,
                                             int d, int w0, int W) {
  Part<F> p;
  const int w = w0 + 8 * (threadIdx.x & 31);
  const int64_t at = static_cast<int64_t>(d) * W + w;
  if constexpr (F::kVal != Val::kF16) {
    p.mn = __ldg(vmin + d);
    p.st = __ldg(vstep + d);
  } else {
    p.mn = p.st = 0.0f;
  }
  if (kVec) {
    // a whole span (the same for every lane) or this lane's 8 entries
    const bool in = w0 + kSpanU8 <= W || w < W;
    if constexpr (F::kVal == Val::kF16) {
      const int* q = static_cast<const int*>(ids) + at;
      const uint4 a = in ? ldg4(q) : make_uint4(~0u, ~0u, ~0u, ~0u);
      const uint4 b = in ? ldg4(q + 4) : make_uint4(~0u, ~0u, ~0u, ~0u);
      const unsigned x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        p.id[k] = __byte_perm(x[2 * k], x[2 * k + 1], 0x7632);
        p.val[k] = __byte_perm(x[2 * k], x[2 * k + 1], 0x5410);
      }
      return p;
    } else {
      if constexpr (F::kWide) {
        const int* q = static_cast<const int*>(ids) + at;
        const uint4 a = in ? ldg4(q) : make_uint4(kPad, kPad, kPad, kPad);
        const uint4 b = in ? ldg4(q + 4) : make_uint4(kPad, kPad, kPad, kPad);
        p.id[0] = a.x; p.id[1] = a.y; p.id[2] = a.z; p.id[3] = a.w;
        p.id[4] = b.x; p.id[5] = b.y; p.id[6] = b.z; p.id[7] = b.w;
      } else {
        const uint4 a = in ? ldg4(static_cast<const int16_t*>(ids) + at)
                           : make_uint4(~0u, ~0u, ~0u, ~0u);
        p.id[0] = a.x; p.id[1] = a.y; p.id[2] = a.z; p.id[3] = a.w;
      }
      if constexpr (F::kVal == Val::kU8) {
        const uint2 c =
            in ? __ldg(reinterpret_cast<const uint2*>(
                     static_cast<const uint8_t*>(codes) + at))
               : make_uint2(0u, 0u);
        p.val[0] = c.x; p.val[1] = c.y;
      } else {
        const uint4 c = in ? ldg4(static_cast<const uint16_t*>(codes) + at)
                           : make_uint4(0u, 0u, 0u, 0u);
        p.val[0] = c.x; p.val[1] = c.y; p.val[2] = c.z; p.val[3] = c.w;
      }
      return p;
    }
  }
  unsigned h[8], x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in = w + j < W;
    if constexpr (F::kVal == Val::kF16) {
      const unsigned word =
          in ? static_cast<unsigned>(__ldg(static_cast<const int*>(ids) +
                                           at + j))
             : 0xffff0000u;  // id -1, value +0.0
      h[j] = word >> 16;
      x[j] = word & 0xffffu;
    } else {
      if constexpr (F::kWide) {
        h[j] = in ? static_cast<unsigned>(
                        __ldg(static_cast<const int*>(ids) + at + j))
                  : static_cast<unsigned>(kPad);
      } else {
        h[j] = in ? static_cast<uint16_t>(
                        __ldg(static_cast<const int16_t*>(ids) + at + j))
                  : 0xffffu;
      }
      if constexpr (F::kVal == Val::kU8) {
        x[j] = in ? static_cast<unsigned>(
                        __ldg(static_cast<const uint8_t*>(codes) + at + j))
                  : 0u;
      } else {
        x[j] = in ? static_cast<unsigned>(
                        __ldg(static_cast<const uint16_t*>(codes) + at + j))
                  : 0u;
      }
    }
  }
  if constexpr (F::kWide) {
#pragma unroll
    for (int j = 0; j < 8; ++j) p.id[j] = h[j];
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p.id[k] = h[2 * k] | (h[2 * k + 1] << 16);
  }
  if constexpr (F::kVal == Val::kU8) {
    p.val[0] = x[0] | (x[1] << 8) | (x[2] << 16) | (x[3] << 24);
    p.val[1] = x[4] | (x[5] << 8) | (x[6] << 16) | (x[7] << 24);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p.val[k] = x[2 * k] | (x[2 * k + 1] << 16);
  }
  return p;
}

// id j of a part: the int16 forms' as uint16 (65535 for a -1)
template <class F>
__device__ __forceinline__ unsigned part_id(const Part<F>& p, int j) {
  if constexpr (F::kWide) {
    return sel8(p.id, j);
  } else {
    return (sel4(p.id, j >> 1) >> ((j & 1) << 4)) & 0xffffu;
  }
}

// value j of a part, decoded: code * step + min as two rounded f32 ops
// (no FMA contraction), or the f16 bits widened (exact)
template <class F>
__device__ __forceinline__ float part_value(const Part<F>& p, int j) {
  if constexpr (F::kVal == Val::kU8) {
    const float x = static_cast<float>((sel2(p.val, j >> 2) >> ((j & 3) << 3))
                                       & 255u);
    return __fadd_rn(__fmul_rn(x, p.st), p.mn);
  } else {
    const unsigned bits = (sel4(p.val, j >> 1) >> ((j & 1) << 4)) & 0xffffu;
    if constexpr (F::kVal == Val::kU16) {
      return __fadd_rn(__fmul_rn(static_cast<float>(bits), p.st), p.mn);
    } else {
      return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
    }
  }
}

// whether a part holds a padding id (also every slot past W)
template <class F>
__device__ __forceinline__ bool part_has_pad(const Part<F>& p) {
  if constexpr (F::kWide) {
    bool pad = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) pad = pad || p.id[j] == static_cast<unsigned>(kPad);
    return pad;
  } else {
    return ((p.id[0] | p.id[1] | p.id[2] | p.id[3]) & 0x80008000u) != 0u;
  }
}

// Bits j < 8: the ids whose filter bit is set. int16 forms: a -1 id tests
// a clear bit; wide forms: the bit of the id's low 16 bits.
template <class F>
__device__ __forceinline__ unsigned part_hits(const Part<F>& p,
                                              const unsigned* s_bits) {
  if constexpr (F::kWide) {
    unsigned hit = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) hit |= term_filter_one(s_bits, p.id[j]) << j;
    return hit;
  } else {
    return term_filter_pair(s_bits, p.id[0]) |
           term_filter_pair(s_bits, p.id[1]) << 2 |
           term_filter_pair(s_bits, p.id[2]) << 4 |
           term_filter_pair(s_bits, p.id[3]) << 6;
  }
}

// This lane's share of the row's score: each id tested in the filter,
// and only the hits looked up, decoded and multiplied by their summed
// value.
template <class F, bool kBig>
__device__ __forceinline__ float score_part(const Part<F>& p,
                                            const unsigned* s_bits,
                                            const Terms<kBig>& terms) {
  unsigned hit = part_hits(p, s_bits);
  float part = 0.0f;
  while (hit != 0u) {
    const int j = __ffs(hit) - 1;
    hit &= hit - 1u;
    const int c = static_cast<int>(part_id(p, j));
    float t;
    if (terms.walk()) {
      t = terms.walk_value(c);
    } else {
      t = F::kWide ? term_find_or_zero(terms.tab, c, terms.bits)
                   : term_find_present(terms.tab, c, terms.bits);
    }
    part += __fmul_rn(part_value(p, j), t);
  }
  return part;
}

// Score row r (doc d >= 0, its first span in p) and write it.
template <class F, bool kVec, bool kBig>
__device__ __forceinline__ void finish_row(
    const Part<F>& p, int d, int r, const void* __restrict__ ids,
    const void* __restrict__ codes, const float* __restrict__ vmin,
    const float* __restrict__ vstep, const unsigned* s_bits,
    const Terms<kBig>& terms, int W, float* __restrict__ out_b) {
  float part = score_part<F, kBig>(p, s_bits, terms);
  // a row longer than a span goes on while its last span held no padding
  if (W > kSpanU8) {
    Part<F> c = p;
    for (int w0 = kSpanU8; w0 < W; w0 += kSpanU8) {
      if (__ballot_sync(0xffffffffu, part_has_pad(c)) != 0u) break;
      c = load_part<F, kVec>(ids, codes, vmin, vstep, d, w0, W);
      part += score_part<F, kBig>(c, s_bits, terms);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, off);
  }
  if ((threadIdx.x & 31) == 0) out_b[r] = part;
}

// kBig: a query of more than kTermStaticTerms terms, its table in dynamic
// shared memory or its row walked (Terms; an instance of its own, so the
// static table's carries nothing of it)
template <class F, bool kVec, bool kSkip, bool kBig>
__global__ void __launch_bounds__(kThreads,
                                  kBig ? kBigLeanBlocks : F::kBlocks)
rescore_lean_kernel(const void* __restrict__ ids,    // [n_docs, W]
                    const void* __restrict__ codes,  // [n_docs, W] or null
                    const float* __restrict__ vmin,  // [n_docs] or null
                    const float* __restrict__ vstep, // [n_docs] or null
                    const int* __restrict__ doc_ids, // [B, R]
                    const int* __restrict__ qc,      // [B, SC]
                    const float* __restrict__ qv,    // [B, SC]
                    int n_docs, int W, int R, int SC,
                    float* __restrict__ out) {       // [B, R]
  K3_TERM_SMEM(kBig);
  __shared__ unsigned s_bits[kFilterWords];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * R;
  const int* ids_b = doc_ids + base;
  float* out_b = out + base;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // A warp's row slots are warp + kWarps k, k = 0, 1, ...; it reads their
  // doc ids 32 at a time (lane l: k = k0 + l), one group ahead, and takes
  // the rows it must read from the group's ballot: under the skip, a slot
  // out of range is written -inf at once and never visited; without it
  // every slot is read, its id clamped.
  const int nk = R > warp ? (R - warp + kWarps - 1) / kWarps : 0;
  auto slot_of = [=](int k) { return warp + kWarps * k; };
  auto raw_at = [=](int k0) {
    const int k = k0 + lane;
    return k < nk ? __ldg(ids_b + slot_of(k)) : -1;
  };
  auto in_range = [=](int x) { return x >= 0 && x < n_docs; };
  int k0 = 0;
  int xc = raw_at(0);           // this group's ids
  int xn = raw_at(kSpanGroup);  // the next group's
  auto take_group = [&]() {     // the rows of group k0 to read
    const bool real = k0 + lane < nk && (!kSkip || in_range(xc));
    if (kSkip && k0 + lane < nk && !real) {
      out_b[slot_of(k0 + lane)] = __uint_as_float(kNegInfBits);
    }
    return __ballot_sync(0xffffffffu, real);
  };
  unsigned m = take_group();
  // the next row to read: its slot and doc, or false past the warp's last
  auto next_row = [&](int& r, int& d) {
    while (m == 0u) {
      k0 += kSpanGroup;
      if (k0 >= nk) return false;
      xc = xn;
      xn = raw_at(k0 + kSpanGroup);
      m = take_group();
    }
    const int l = __ffs(m) - 1;
    m &= m - 1u;
    const int x = __shfl_sync(0xffffffffu, xc, l);
    r = slot_of(k0 + l);
    d = kSkip || in_range(x) ? x : (x < 0 ? 0 : n_docs - 1);
    return true;
  };

  // two rows in flight (the next row's part loads while this one
  // scores), their parts alternating between a and b so none is copied;
  // the first row's part loads while the block builds its tables
  int ra = 0, da = -1, rb = 0, db = -1;
  bool have_a = next_row(ra, da);
  Part<F> a;
  if (have_a) a = load_part<F, kVec>(ids, codes, vmin, vstep, da, 0, W);
  term_filter_clear(s_bits);
  const Terms<kBig> terms(qc, qv, SC, s_tab1, s_qc1, s_qv1, s_dyn);
  if (terms.walk()) {
    // the filter from the row in device memory, after the clear
    __syncthreads();
    term_filter_build<F::kWide>(
        s_bits, qc + static_cast<int64_t>(blockIdx.x) * SC, SC);
    __syncthreads();
  } else {
    term_table_clear(terms.tab, &s_dup, terms.bits);
    stage_terms(qc, qv, blockIdx.x, SC, terms.s_qc, terms.s_qv, &s_n);
    __syncthreads();
    term_filter_build<F::kWide>(s_bits, terms.s_qc, s_n);
    // its barrier: both
    term_table_build(terms.tab, terms.s_qc, terms.s_qv, s_n, &s_dup,
                     terms.bits);
  }

  while (have_a) {
    const bool have_b = next_row(rb, db);
    // with no next row, this row's part again: an L1 hit, never scored
    const Part<F> b = load_part<F, kVec>(ids, codes, vmin, vstep,
                                         have_b ? db : da, 0, W);
    finish_row<F, kVec, kBig>(a, da, ra, ids, codes, vmin, vstep, s_bits,
                              terms, W, out_b);
    if (!have_b) break;
    have_a = next_row(ra, da);
    a = load_part<F, kVec>(ids, codes, vmin, vstep, have_a ? da : db, 0, W);
    finish_row<F, kVec, kBig>(b, db, rb, ids, codes, vmin, vstep, s_bits,
                              terms, W, out_b);
  }
}

// The dynamic shared memory of a kBig instance for a row of SC terms
// (term_smem: 0 where the row is walked), the kernel opted in once per
// device to the most any row takes; minus the CUDA error if that failed.
template <typename K>
int big_smem(K kernel, int SC, bool (&opted)[kMaxDevices]) {
  const int smem = term_smem(SC);
  if (smem > 48 * 1024) {
    const cudaError_t e = opt_in_smem(kernel, kTermMaxSmem, opted);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return smem;
}

template <class F, bool kVec, bool kSkip>
int launch_lean_one(const void* ids, const void* codes, const float* vmin,
                    const float* vstep, const int* doc_ids, const int* qc,
                    const float* qv, int B, int R, int SC, int n_docs, int W,
                    float* out, cudaStream_t stream) {
  if (SC > kTermStaticTerms) {
    // the kBig instance loads a part's entries one at a time (one instance
    // a form and contract, whatever the alignment)
    auto kernel = rescore_lean_kernel<F, false, kSkip, true>;
    static bool opted[kMaxDevices];
    const int rc = big_smem(kernel, SC, opted);
    if (rc < 0) return -rc;
    kernel<<<B, kThreads, rc, stream>>>(ids, codes, vmin, vstep, doc_ids, qc,
                                        qv, n_docs, W, R, SC, out);
  } else {
    rescore_lean_kernel<F, kVec, kSkip, false><<<B, kThreads, 0, stream>>>(
        ids, codes, vmin, vstep, doc_ids, qc, qv, n_docs, W, R, SC, out);
  }
  return 0;
}

template <class F, bool kVec>
int launch_lean(const void* ids, const void* codes, const float* vmin,
                const float* vstep, const int* doc_ids, const int* qc,
                const float* qv, int B, int R, int SC, int n_docs, int W,
                bool skip, float* out, cudaStream_t stream) {
  return skip ? launch_lean_one<F, kVec, true>(ids, codes, vmin, vstep,
                                               doc_ids, qc, qv, B, R, SC,
                                               n_docs, W, out, stream)
              : launch_lean_one<F, kVec, false>(ids, codes, vmin, vstep,
                                                doc_ids, qc, qv, B, R, SC,
                                                n_docs, W, out, stream);
}

bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

// Launch form F: the vector loads when every row and span start is
// aligned for them (W % 8 == 0: a span of 8 entries of a row is 16 bytes
// of int16 ids, 32 of int32 ids or words, 8 of u8 and 16 of u16 codes).
template <class F>
int run_lean(const void* ids, const void* codes, const float* vmin,
             const float* vstep, const int* doc_ids, const int* qc,
             const float* qv, int B, int R, int SC, int n_docs, int W,
             int skip, float* out, cudaStream_t stream) {
  if (B > 0 && R > 0) {
    const bool vec = W % 8 == 0 && aligned(ids, 16) &&
                     (F::kVal == Val::kF16 ||
                      aligned(codes, F::kVal == Val::kU8 ? 8 : 16));
    const int rc =
        vec ? launch_lean<F, true>(ids, codes, vmin, vstep, doc_ids, qc, qv,
                                   B, R, SC, n_docs, W, skip != 0, out,
                                   stream)
            : launch_lean<F, false>(ids, codes, vmin, vstep, doc_ids, qc,
                                    qv, B, R, SC, n_docs, W, skip != 0, out,
                                    stream);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Any SC: up to 256 the query's terms go into the static table, past it
// into one sized at run time in dynamic shared memory, and past 8192 they
// are walked in device memory.
int seismic_rescore_fused(const int* fwd, const int* doc_ids, const int* qc,
                          const float* qv, int B, int R, int SC, int n_docs,
                          int W, float* out, cudaStream_t stream) {
  if (B > 0 && R > 0) {
    if (SC > kTermStaticTerms) {
      auto kernel = rescore_fused_kernel<true>;
      static bool opted[kMaxDevices];
      const int rc = big_smem(kernel, SC, opted);
      if (rc < 0) return -rc;
      kernel<<<B, kThreads, rc, stream>>>(fwd, doc_ids, qc, qv, n_docs, W, R,
                                          SC, out);
    } else {
      rescore_fused_kernel<false><<<B, kThreads, 0, stream>>>(
          fwd, doc_ids, qc, qv, n_docs, W, R, SC, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// the half-width fused rows: fwd16 int32 [n_docs, W]
int seismic_rescore_fused16(const int* fwd16, const int* doc_ids,
                            const int* qc, const float* qv, int B, int R,
                            int SC, int n_docs, int W, int skip, float* out,
                            cudaStream_t stream) {
  return run_lean<FormF16>(fwd16, nullptr, nullptr, nullptr, doc_ids, qc, qv,
                           B, R, SC, n_docs, W, skip, out, stream);
}

// the lean form: ids int16 (id_bytes 2) or int32 (4), codes u8
// (code_bytes 1) or u16 (2), each [n_docs, W]
int seismic_rescore_lean(const void* ids, int id_bytes, const void* codes,
                         int code_bytes, const float* vmin,
                         const float* vstep, const int* doc_ids,
                         const int* qc, const float* qv, int B, int R,
                         int SC, int n_docs, int W, int skip, float* out,
                         cudaStream_t stream) {
  if (id_bytes == 2 && code_bytes == 1) {
    return run_lean<FormU8>(ids, codes, vmin, vstep, doc_ids, qc, qv, B, R,
                            SC, n_docs, W, skip, out, stream);
  }
  if (id_bytes == 2 && code_bytes == 2) {
    return run_lean<FormU16>(ids, codes, vmin, vstep, doc_ids, qc, qv, B, R,
                             SC, n_docs, W, skip, out, stream);
  }
  if (id_bytes == 4 && code_bytes == 1) {
    return run_lean<FormU8W>(ids, codes, vmin, vstep, doc_ids, qc, qv, B, R,
                             SC, n_docs, W, skip, out, stream);
  }
  if (id_bytes == 4 && code_bytes == 2) {
    return run_lean<FormU16W>(ids, codes, vmin, vstep, doc_ids, qc, qv, B,
                              R, SC, n_docs, W, skip, out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
