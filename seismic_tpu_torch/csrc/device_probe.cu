// The device probe's nine kernels (K10-K18 of PERF.md's table), one entry
// point each, plus two for the timing: an empty kernel (the launch floor)
// and one that holds the stream while the host queues launches behind it.
//
// Replaces the nine pallas_calls of seismic_tpu/harness/device_probe.py:
//   K10 table_take         vmem_table_take (:86)
//   K11 row_gather         row_dma_gather (:151)
//   K12 compare_intersect  compare_intersect_kernel (:188)
//   K13 u8_matvec          u8_tile_matmul (:230)
//   K14 take_along_axis    take_along_axis_sublane (:270)
//   K15 flat_row_gather    flat_row_dma (:338)
//   K16 compare_term_loop  compare_term_loop (:382)
//   K17 i8_matmul          int8_cast_matmul (:426)
//   K18 tile_matvec        pallas_pipelined_blocks (:554)
// Each computes what its TPU kernel computes (the formulas sit beside each
// kernel below); none carries a Mosaic block layout over. Indices outside
// their table read nothing and give 0, in the plain versions too
// (seismic_tpu_torch/ops/probe_kernels.py): the TPU kernels would fault.
//
// Bounds on an H100 (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s f32 on the CUDA
// cores, 989 TFLOP/s bf16 on the tensor cores): every one of them moves
// under 50 MB, so K10, K12-K14, K16 and K17 have bounds under 1 us, K11 /
// K15 2.5 us (4096 rows of 1 KB), K18 about 14 us of int8 tiles; a launch
// costs more than most. The designs are the simple right ones: K11 / K15
// a warp per output row with 16-byte loads (the card's loads gather what
// the TPU needed a DMA ring for; a ring of bulk copies was measured and
// lost, see below), K18's query row staged in shared memory, K10's and
// K14's tables read through the caches, f32 FMAs on the CUDA cores; K13
// and K14 are one round of loads each, issued before any arithmetic, with
// no shared memory and no barrier, over 4-warp blocks that fill the card;
// K12 and K16 are one kernel that looks each element up in a shared-memory
// hash table of the query's terms (term_table.cuh, as K1, K3, K8 and K9),
// over 4-warp blocks that fill the card; K17's product runs on the bf16
// tensor cores (mma.sync) over a grid that fills the card.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "grouped_i8_mma.cuh"  // mma_bf16, int4_word, MmaBf16 (K17)
#include "term_table.cuh"      // the term lookup (K12, K16)

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTerms = 1024;  // K12 / K16 take at most this many terms

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// ---- K10: out[e] = table[idx[e]], the table read through the caches ----
// The TPU kernel holds the table in VMEM. On this card a table that many
// lookups share stays in the 50 MB L2 and in each SM's L1 anyway, so the
// kernel stages nothing: each thread serves 4 lookups from one 16-byte
// load of idx (or 4 scalar loads where idx is not 16-byte aligned, and
// for the n % 4 tail), reads table[j] through the read-only path (__ldg:
// L1, then L2) and stores a float4. The grid is sized to the lookups, so
// even a few thousand of them spread over many SMs; the table is bounded
// only by int indexing. Staging the table in every block's shared memory
// would read more table bytes than the lookups need.
constexpr int kTakeThreads = 128;

__device__ __forceinline__ float take_one(const float* __restrict__ table,
                                          int n_table, int j) {
  return static_cast<unsigned>(j) < static_cast<unsigned>(n_table)
             ? __ldg(table + j)
             : 0.0f;
}

template <bool kVec>
__global__ void __launch_bounds__(kTakeThreads)
table_take_kernel(const float* __restrict__ table, int n_table,
                  const int* __restrict__ idx, int n,
                  float* __restrict__ out) {
  const int64_t e0 =
      4 * (static_cast<int64_t>(blockIdx.x) * kTakeThreads + threadIdx.x);
  if (e0 >= n) return;
  if (kVec && e0 + 4 <= n) {
    const int4 j = reinterpret_cast<const int4*>(idx)[e0 / 4];
    reinterpret_cast<float4*>(out)[e0 / 4] = make_float4(
        take_one(table, n_table, j.x), take_one(table, n_table, j.y),
        take_one(table, n_table, j.z), take_one(table, n_table, j.w));
    return;
  }
  const int64_t end = e0 + 4 < n ? e0 + 4 : n;
  for (int64_t e = e0; e < end; ++e) {
    out[e] = take_one(table, n_table, idx[e]);
  }
}

// ---- K11 / K15: out[r, :] = src[idx[r] * W : idx[r] * W + W] ----
// K11 reads a [n, W] table (valid rows 0 <= j < n), K15 a flat one of n
// elements (valid where j * W + W <= n); the addresses are the same, so
// one kernel serves both. It replaces row_dma_gather and flat_row_dma,
// which keep a ring of 8 (K15: 16) row DMAs in flight through VMEM and
// copy each arrived slot out: the TPU has no gather load, the card does.
// A warp per row, 8 rows a block; each lane loads idx[r] (one sector for
// the block), then its float4s of the row (W % 4 == 0, 16-byte aligned
// base) and stores them; offsets in 64 bits (the probe's tables hold 256M
// floats). At the probe's 4096 rows the 512 blocks are all resident at
// once, so every row's loads are in flight together.
//
// Bound on an H100: the bytes, 8.4 MB at the probe's 4096 rows of 1 KB
// (each distinct row read once, idx read, the rows written once), 2.51 us
// at 3.35 TB/s. Each row is two dependent trips to device memory, idx and
// then the row at a random place in 1 GB, and no design removes them. On
// an H100 80GB HBM3 at 700 W, in turns in one process
// (harness/row_gather_probe.py, 9 window pairs a flushed reading), this
// kernel read 3.6 us warm and 7.2 with L2 flushed by a read, at 0.84 ns a
// row over a 3.7 us intercept (R 1024-16,384; an empty kernel reads 1.8);
// rows from one 8 MB span (4 pages, not most of 512) read 0.1 us less, so
// address translation is not what costs. Tried and not kept: a ring of
// bulk copies (cp.async.bulk in and out of shared memory, the DMA ring's
// counterpart: 5.5-5.6 us warm and 7.8-8.7 flushed by a read with one
// lane issuing a block's copies, 4.0-4.1 and 7.4-8.0 with them spread
// over lanes or blocks; a warp issues the copies of its lanes one after
// another and each row waits in shared memory for its barrier) and 1-2
// rows a warp with no-allocate loads all issued before the stores
// (3.2-4.0 warm, 6.9-7.2 flushed by a read: level with this one's build
// timed in the same turns, 6.9-7.2, where it counts).
template <bool kFlat>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ src, int64_t n,
                  const int* __restrict__ idx, int R, int W,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int64_t j = idx[r];
  const bool valid = kFlat ? (j >= 0 && j * W + W <= n) : (j >= 0 && j < n);
  float4* o = reinterpret_cast<float4*>(out + static_cast<int64_t>(r) * W);
  const int W4 = W / 4;
  if (valid) {
    const float4* row = reinterpret_cast<const float4*>(src + j * W);
#pragma unroll 4
    for (int c = lane; c < W4; c += 32) o[c] = row[c];
  } else {
    for (int c = lane; c < W4; c += 32) {
      o[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// ---- K12 / K16: compare-intersection scoring, as a term lookup ----
//   out[t] = sum_w vals[t, w] * sum_q qv[q] * [comps[t, w] == qc[q]]
//          = sum_w vals[t, w] * qd[comps[t, w]]
// where qd[c] is the f32 sum, in term order from 0.0f, of the values of
// the terms whose id is c: the compare loop's own sum (term_table.cuh).
// The two TPU bodies differ only in loop form (K12's broadcast compare,
// K16's loop over the terms outside), so both entry points launch this
// one kernel. Bound on an H100: the bytes (T W 8 + Q 8 + T 4, 0.63 us at
// the probe's [1024, 256] x 64 terms), under a launch; where a compare
// loop runs Q dependent compare-selects an element, the lookup does one
// shared-memory probe and one FMA.
//
// A block of kCmpWarps warps, a warp a row, so the probe's 1024 rows fill
// 256 blocks (about 2 an SM). Each thread issues its terms' loads, then
// its warp's row's first pass of loads (16-byte loads of comps and vals
// where W % 4 == 0 and both are 16-byte aligned, scalar loads otherwise)
// before the table is built, so the build runs under the row's latency.
// The block stages the terms in shared memory and enters them into
// term_table.cuh's table (build_terms: an atomicCAS a term, a repeated id
// summed in term order by a warp). The table's empty key kTermEmpty
// cannot be entered: the values of the terms equal to it are summed in
// term order into one shared scalar, which an element equal to it reads.
// Most elements miss, and a miss walks past every key in its way, so the
// table is sparse: 2^bits >= 16 Q slots, from 1024 (8 KB) up to 4096 (32
// KB, a load 1/4 at kMaxTerms), in dynamic shared memory. Each lane then
// looks its kCmpPer elements of a pass up, all walks stepping together
// (lookup_together), and adds vals * qd with fmaf; a warp sum gives the
// row. A row wider than a pass loops.
constexpr int kCmpWarps = 4;
constexpr int kCmpThreads = kCmpWarps * 32;
constexpr int kCmpPer = 8;              // elements of a lane a pass
constexpr int kCmpPass = 32 * kCmpPer;  // elements of a row a pass
constexpr int kCmpMinBits = 10;
constexpr int kCmpMaxBits = 12;

// The summed values of a lane's kCmpPer ids (0.0f for an id no term has,
// and for kTermEmpty, which is not probed): the first probes of all of
// them are issued together, then every id still on another id's slot
// steps on at once, so a lane waits for its longest walk, not for the
// sum of its walks (lookup8 walks one id after the other).
__device__ __forceinline__ void lookup_together(const int2* s_tab,
                                                const int (&c)[kCmpPer],
                                                float (&x)[kCmpPer],
                                                int bits) {
  int h[kCmpPer];
  int2 e[kCmpPer];
#pragma unroll
  for (int k = 0; k < kCmpPer; ++k) {
    h[k] = term_slot(c[k], bits);
    e[k] = c[k] != kTermEmpty ? s_tab[h[k]] : make_int2(kTermEmpty, 0);
  }
  for (bool walk = true; walk;) {
    walk = false;
#pragma unroll
    for (int k = 0; k < kCmpPer; ++k) {
      if (e[k].x != c[k] && e[k].x != kTermEmpty) {
        h[k] = term_next(h[k], bits);
        e[k] = s_tab[h[k]];
        walk = true;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kCmpPer; ++k) {
    x[k] = e[k].x == c[k] ? __int_as_float(e[k].y) : 0.0f;
  }
}

// A lane's kCmpPer elements of the pass from w0: with kVec those at w0 +
// 4 (lane + 32 h) + j (two 16-byte loads of each operand), else those at
// w0 + lane + 32 k. Elements past W read nothing: in[k] is false.
template <bool kVec>
__device__ __forceinline__ void load_pass(const int* __restrict__ crow,
                                          const float* __restrict__ vrow,
                                          int w0, int W, int lane,
                                          int (&c)[kCmpPer],
                                          float (&v)[kCmpPer],
                                          bool (&in)[kCmpPer]) {
  if constexpr (kVec) {
#pragma unroll
    for (int h = 0; h < kCmpPer / 4; ++h) {
      const int w = w0 + 4 * (lane + 32 * h);
      const bool ok = w < W;  // W % 4 == 0: all four or none
      const int4 ci = ok ? *reinterpret_cast<const int4*>(crow + w)
                         : make_int4(kTermEmpty, kTermEmpty, kTermEmpty,
                                     kTermEmpty);
      const float4 vi = ok ? *reinterpret_cast<const float4*>(vrow + w)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int cs[4] = {ci.x, ci.y, ci.z, ci.w};
      const float vs[4] = {vi.x, vi.y, vi.z, vi.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[4 * h + j] = cs[j];
        v[4 * h + j] = vs[j];
        in[4 * h + j] = ok;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCmpPer; ++k) {
      const int w = w0 + lane + 32 * k;
      in[k] = w < W;
      c[k] = in[k] ? crow[w] : kTermEmpty;
      v[k] = in[k] ? vrow[w] : 0.0f;
    }
  }
}

// The f32 sum, in term order from 0.0f, of the values of the staged terms
// whose id is c, by one warp, 32 terms a step (a ballot of the matches,
// their values added lane by lane); every lane returns it.
__device__ __forceinline__ float sum_in_order(const int* s_qc,
                                              const float* s_qv, int Q,
                                              int c) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float sum = 0.0f;
  for (int j0 = 0; j0 < Q; j0 += 32) {
    const int j = j0 + lane;
    const bool hit = j < Q && s_qc[j] == c;
    const float v = hit ? s_qv[j] : 0.0f;
    for (unsigned m = __ballot_sync(all, hit); m; m &= m - 1u) {
      sum += __shfl_sync(all, v, __ffs(m) - 1);
    }
  }
  return sum;
}

// Enter the Q staged terms (s_qc / s_qv, in term order) into the cleared
// table, as term_table_build does (one atomicCAS a term, each id's values
// summed in term order from 0.0f), except that a kTermEmpty term is left
// out and that a repeated id is summed by a warp (sum_in_order), where
// term_table_build has the first of its terms walk the terms alone. Every
// thread of the block calls it (Q <= 32 * kCmpThreads); it returns after
// the block's last __syncthreads, the table complete.
__device__ __forceinline__ void build_terms(int2* s_tab, const int* s_qc,
                                            const float* s_qv, int Q,
                                            int* s_dup, int bits) {
  const unsigned all = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31;
  unsigned rep = 0u;  // bit k: the thread's k-th term found its id entered
  for (int i = tid, k = 0; i < Q; i += kCmpThreads, ++k) {
    const int c = s_qc[i];
    if (c == kTermEmpty) continue;
    int h = term_slot(c, bits);
    int prev;
    while ((prev = atomicCAS(&s_tab[h].x, kTermEmpty, c)) != kTermEmpty &&
           prev != c) {
      h = term_next(h, bits);
    }
    if (prev == kTermEmpty) {
      s_tab[h].y = __float_as_int(__fadd_rn(0.0f, s_qv[i]));
    } else {
      rep |= 1u << k;
      *s_dup = 1;
    }
  }
  __syncthreads();
  if (!*s_dup) return;
  // each warp takes the repeated terms its lanes found, one at a time; the
  // lane that found one writes the id's sum (another term of the id may
  // write the same sum)
  for (unsigned who; (who = __ballot_sync(all, rep != 0u));) {
    const int src = __ffs(who) - 1;
    const int k = __ffs(__shfl_sync(all, rep, src)) - 1;
    const int c = s_qc[tid - lane + src + k * kCmpThreads];
    const float sum = sum_in_order(s_qc, s_qv, Q, c);
    if (lane == src) {
      rep &= rep - 1u;
      int h = term_slot(c, bits);
      while (s_tab[h].x != c) h = term_next(h, bits);
      s_tab[h].y = __float_as_int(sum);
    }
  }
  __syncthreads();
}

template <bool kVec>
__global__ void __launch_bounds__(kCmpThreads)
compare_lookup_kernel(const int* __restrict__ comps,
                      const float* __restrict__ vals,
                      const int* __restrict__ qc, const float* __restrict__ qv,
                      int T, int W, int Q, int bits,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  int2* s_tab = reinterpret_cast<int2*>(s_raw);
  int* s_qc = reinterpret_cast<int*>(s_tab + (1 << bits));
  float* s_qv = reinterpret_cast<float*>(s_qc + Q);
  __shared__ int s_dup;
  __shared__ float s_empty;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kCmpWarps + warp;
  const bool row_ok = t < T;
  const int* crow = comps + static_cast<int64_t>(row_ok ? t : 0) * W;
  const float* vrow = vals + static_cast<int64_t>(row_ok ? t : 0) * W;
  // every thread stages its terms in place (term order kept), their loads
  // issued first: the table waits for them, the lookups for the row's
  if (threadIdx.x == 0) s_empty = 0.0f;
  int has_empty = 0;
  for (int i = threadIdx.x; i < Q; i += kCmpThreads) {
    const int cq = qc[i];
    s_qc[i] = cq;
    s_qv[i] = qv[i];
    has_empty |= cq == kTermEmpty;
  }
  int c[kCmpPer];
  float v[kCmpPer];
  bool in[kCmpPer];
  if (row_ok) load_pass<kVec>(crow, vrow, 0, W, lane, c, v, in);
  term_table_clear(s_tab, &s_dup, bits);
  has_empty = __syncthreads_or(has_empty);
  build_terms(s_tab, s_qc, s_qv, Q, &s_dup, bits);
  if (has_empty) {
    // the values of the terms equal to the empty key, summed by warp 0
    if (warp == 0) {
      const float empty = sum_in_order(s_qc, s_qv, Q, kTermEmpty);
      if (lane == 0) s_empty = empty;
    }
    __syncthreads();
  }
  if (!row_ok) return;

  const float empty = s_empty;
  float part = 0.0f;
  for (int w0 = 0;;) {
    float x[kCmpPer];
    lookup_together(s_tab, c, x, bits);
#pragma unroll
    for (int k = 0; k < kCmpPer; ++k) {
      const float qd = c[k] == kTermEmpty ? empty : x[k];
      if (in[k]) part = fmaf(v[k], qd, part);
    }
    w0 += kCmpPass;
    if (w0 >= W) break;
    load_pass<kVec>(crow, vrow, w0, W, lane, c, v, in);
  }
  part = warp_sum(part);
  if (lane == 0) out[t] = part;
}

// The table's bits for Q <= kMaxTerms terms: 2^bits >= 16 Q, within
// [kCmpMinBits, kCmpMaxBits].
int compare_bits(int Q) {
  int bits = kCmpMinBits;
  while ((1 << bits) < 16 * Q && bits < kCmpMaxBits) ++bits;
  return bits;
}

// ---- K13: out[m] = (sum_k f32(tile[m, k]) * q[k]) * scale[m] ----
// Bound on an H100: the bytes (M K + 4 K + 8 M, 0.08 us at the probe's
// [512, 512]), far under a launch, so the kernel is one round of loads
// over a grid that fills the card. A warp a row, 4 warps a block (the
// probe's 512 rows are 128 blocks, about one an SM). Lane l takes the 16
// columns 16 l .. 16 l + 15 of each 512-column pass and issues, before its
// first FMA, its 16 bytes of the row (one 16-byte load where K % 16 == 0
// and tile and q are 16-byte aligned, four 4-byte loads otherwise), its
// 16 values of q (four float4 loads through the read-only path: every
// warp reads the same q, and L1 / L2 serve the repeats; scalar loads in
// the 4-byte variant) and, on lane 0, scale[m]. No shared memory, no
// barrier. A lane adds its 16 products in column order with fmaf, pass
// after pass; the warp's xor tree sums the lanes and lane 0 multiplies by
// scale[m]. Columns past K read nothing (K % 4 == 0, so a lane's columns
// end on a whole group of 4).
constexpr int kMvWarps = 4;
constexpr int kMvThreads = kMvWarps * 32;
constexpr int kMvPass = 32 * 16;  // columns of a row a pass

template <bool kVec>
__global__ void __launch_bounds__(kMvThreads)
u8_matvec_kernel(const uint8_t* __restrict__ tile, const float* __restrict__ q,
                 const float* __restrict__ scale, int M, int K,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kMvWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const uint8_t* row = tile + static_cast<int64_t>(m) * K;
  const float s = lane == 0 ? __ldg(scale + m) : 0.0f;
  float part = 0.0f;
  for (int k = 16 * lane; k < K; k += kMvPass) {
    unsigned x[4];  // 4 bytes of the row each, column k + 4 g first
    float y[16];
    bool in[4];     // group g of 4 columns inside the row
    if constexpr (kVec) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + k));
      x[0] = w.x, x[1] = w.y, x[2] = w.z, x[3] = w.w;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(q + k) + g);
        y[4 * g] = v.x, y[4 * g + 1] = v.y, y[4 * g + 2] = v.z,
        y[4 * g + 3] = v.w;
        in[g] = true;  // K % 16 == 0: all 16 columns or none
      }
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        in[g] = k + 4 * g < K;
        x[g] = in[g] ? __ldg(reinterpret_cast<const unsigned*>(row + k) + g)
                     : 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          y[4 * g + b] = in[g] ? __ldg(q + k + 4 * g + b) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float t = static_cast<float>((x[g] >> (8 * b)) & 0xffu);
        if (in[g]) part = fmaf(t, y[4 * g + b], part);
      }
    }
  }
  part = warp_sum(part);
  if (lane == 0) out[m] = part * s;
}

// ---- K14: out[m, c] = table[idx[m, c], c] ----
// Bound on an H100: the bytes (4 R C + 8 M C, 0.20 us at the probe's R
// 256, C 128, M 512), under a launch, so the kernel is one round of
// dependent loads (idx, then the table) over a grid that fills the card.
// A warp a row, 4 warps a block (the probe's [512, 128] is 128 blocks of
// 128 threads). Lane l takes the 4 columns c + l, c + 32 + l, c + 64 + l
// and c + 96 + l of each 128-column step c: the column comes from the
// thread, with no division, and each of the warp's loads and stores of
// idx and out is 128 contiguous bytes, for any C. Its 4 idx loads go out
// together, then its 4 table reads (__ldg: L1, then L2; the 128 KB table
// is read twice over at the probe), all held in registers before the
// first of its 4 stores. The table is not staged:
// a block would copy all of it to read 512 of its elements (K10 found the
// same). An index outside [0, R) reads nothing and gives 0.
constexpr int kTaWarps = 4;
constexpr int kTaThreads = kTaWarps * 32;
constexpr int kTaCols = 4 * 32;  // columns of a row a warp takes a step

__global__ void __launch_bounds__(kTaThreads)
take_along_axis_kernel(const float* __restrict__ table, int R, int C,
                       const int* __restrict__ idx, int64_t M,
                       float* __restrict__ out) {
  const int64_t m =
      static_cast<int64_t>(blockIdx.x) * kTaWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const int* irow = idx + m * C;
  float* orow = out + m * C;
  for (int64_t c = threadIdx.x & 31; c < C; c += kTaCols) {
    int j[4];
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      j[k] = c + 32 * k < C ? __ldg(irow + c + 32 * k) : -1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = static_cast<unsigned>(j[k]) < static_cast<unsigned>(R)
                 ? __ldg(table + static_cast<int64_t>(j[k]) * C + c + 32 * k)
                 : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c + 32 * k < C) orow[c + 32 * k] = v[k];
    }
  }
}

// ---- K17: out[M, N] = f32(tile[M, K]) @ q[K, N] ----
// On the bf16 tensor cores (mma.sync m16n8k16, f32 accumulators) with the
// operands K6's f32 mode proved (grouped_i8_mma.cuh): every int8 is exact
// in bf16, and q is split into three bf16 terms whose sum is q exactly (hi
// = bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid)), each multiplied
// by the same A fragment. So every product is exact and only the f32 sums
// round: each 32-deep k-slice of the three terms is summed by the tensor
// cores in a fresh fragment (lo first), and one rounded FADD adds it to
// the lane's running sum, so the tensor cores' own accumulation, which
// need not round to nearest, never spans more than 32 columns.
//
// Filling the card: a block's output tile is 32 x 16, so the probe's
// [512, 128] output is 16 x 8 = 128 blocks, one an SM. The block's 8 warps
// split K: warp w takes the 64-column slices w, w + 8, ...; the 8 partial
// tiles meet in shared memory and are summed in warp order (rounded f32
// adds), so the result does not depend on scheduling. Nothing is staged:
// each operand element is read by exactly one lane of its block, so the
// loads go straight to registers (16 bytes of A a row and a slice, 4-byte
// loads of q, a warp's 32 lanes reading 4 full 32-byte sectors a load).
// A lane's k order inside a slice is permuted alike for A and B, as in
// K6: lane (g, t) holds columns t * 16 .. + 15 of its rows g, g + 8 and of
// its q columns g (of each n8 tile), and k16 step s reads their columns
// 4s .. 4s + 3. The int8 -> bf16 conversion is K6's, on a sign-flipped
// byte: x ^ 0x80 = x + 128 goes into the mantissa of 2^23 (PRMT), one FADD
// of -(2^23 + 128) leaves x, a PRMT packs two. Rows past M, columns past N
// and K read nothing and give 0; a tile whose rows are not 16-byte aligned
// (K % 16 != 0) reads its bytes one at a time.
//
// Bound on an H100: the bytes (M K + 4 K N + 4 M N) or three bf16 products
// at 989 TFLOP/s, about 0.2 us each at the probe's shape; the launch (2-3
// us of device time) is more than either.
constexpr int kMmM = 32, kMmN = 16;  // a block's output tile
constexpr int kMmSlice = 64;         // k of a warp's loads a round
constexpr int kMmSum = 32;           // k summed in a fresh fragment
constexpr int kMmPitch = kMmN + 8;   // floats a row of a partial tile
constexpr float kFlip = 8388736.0f;  // 2^23 + 128

// 16 bytes of `row` (null: a row past M) from column k; columns at or past
// K give 0
__device__ __forceinline__ int4 row16(const int8_t* __restrict__ row, int k,
                                      int K, bool vec) {
  if (row == nullptr) return make_int4(0, 0, 0, 0);
  if (vec && k + 16 <= K) {
    return __ldg(reinterpret_cast<const int4*>(row + k));
  }
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (k + j < K) {
      w[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(row[k + j]))
                   << (8 * (j & 3));
    }
  }
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                   static_cast<int>(w[2]), static_cast<int>(w[3]));
}

// the three bf16 terms of (x0, x1), each a bf16x2 with x0 low
__device__ __forceinline__ void split3(float x0, float x1,
                                       unsigned (&w)[3]) {
#pragma unroll
  for (int term = 0; term < 3; ++term) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    w[term] = *reinterpret_cast<const unsigned*>(&h);
    // the remainders, exact in f32, for the next term
    x0 = __fsub_rn(x0, __low2float(h));
    x1 = __fsub_rn(x1, __high2float(h));
  }
}

__global__ void __launch_bounds__(kThreads)
i8_matmul_kernel(const int8_t* __restrict__ a, const float* __restrict__ b,
                 int M, int K, int N, float* __restrict__ out) {
  __shared__ __align__(16) float s_part[kWarps][kMmM * kMmPitch];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kMmM, n0 = blockIdx.y * kMmN;
  const bool vec =
      K % 16 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const int8_t* rows[2][2];  // [m16 tile][g, g + 8]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + mt * 16 + h * 8 + g;
      rows[mt][h] = r < M ? a + static_cast<int64_t>(r) * K : nullptr;
    }
  }
  const MmaBf16<3> cvt{kFlip};
  float acc[2][2][4] = {};  // [m16 tile][n8 tile][D fragment]
  for (int k0 = warp * kMmSlice; k0 < K; k0 += kWarps * kMmSlice) {
    const int kl = k0 + t * 16;  // the lane's 16 columns of the slice
    int4 av[2][2];
    float qv[2][16];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) av[mt][h] = row16(rows[mt][h], kl, K, vec);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = n0 + nt * 8 + g;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        qv[nt][j] = n < N && kl + j < K
                        ? __ldg(b + static_cast<int64_t>(kl + j) * N + n)
                        : 0.0f;
      }
    }
#pragma unroll
    for (int half = 0; half < kMmSlice / kMmSum; ++half) {
      float part[2][2][4] = {};
#pragma unroll
      for (int ss = 0; ss < kMmSum / 16; ++ss) {
        const int s = half * (kMmSum / 16) + ss;  // k16 step of the slice
        unsigned af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const unsigned wl = int4_word(av[mt][0], s) ^ 0x80808080u;
          const unsigned wh = int4_word(av[mt][1], s) ^ 0x80808080u;
          af[mt][0] = cvt.a_pair<0>(wl);
          af[mt][1] = cvt.a_pair<0>(wh);
          af[mt][2] = cvt.a_pair<2>(wl);
          af[mt][3] = cvt.a_pair<2>(wh);
        }
        unsigned b0[2][3], b1[2][3];  // [n8 tile][term]
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          split3(qv[nt][4 * s], qv[nt][4 * s + 1], b0[nt]);
          split3(qv[nt][4 * s + 2], qv[nt][4 * s + 3], b1[nt]);
        }
#pragma unroll
        for (int term = 2; term >= 0; --term) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              mma_bf16(part[mt][nt], af[mt][0], af[mt][1], af[mt][2],
                       af[mt][3], b0[nt][term], b1[nt][term]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], part[mt][nt][i]);
          }
        }
      }
    }
  }
  // D fragment: acc[mt][nt][i] is row mt * 16 + g + 8 (i / 2), column
  // nt * 8 + 2t + i % 2
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = mt * 16 + g + 8 * hi;
        *reinterpret_cast<float2*>(
            &s_part[warp][r * kMmPitch + nt * 8 + 2 * t]) =
            make_float2(acc[mt][nt][2 * hi], acc[mt][nt][2 * hi + 1]);
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kMmM * kMmN; e += kThreads) {
    const int r = e / kMmN, c = e % kMmN;
    float v = s_part[0][r * kMmPitch + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      v = __fadd_rn(v, s_part[w][r * kMmPitch + c]);
    }
    if (m0 + r < M && n0 + c < N) {
      out[static_cast<int64_t>(m0 + r) * N + n0 + c] = v;
    }
  }
}

// ---- K18: out[i, r] = sum_v f32(dense[tidx[i] * MB + r, v]) * qloc[i, v] ----
// The data-dependent tile stream: one block per tile i finds its tile from
// tidx (the TPU's scalar-prefetched index map), stages qloc[i] in shared
// memory, and each warp scores rows of the [MB, V] int8 tile, 4 bytes a
// lane (V % 4 == 0), coalesced 128-byte rows segments.
__global__ void __launch_bounds__(kThreads)
tile_matvec_kernel(const int8_t* __restrict__ dense, int n_tiles,
                   const int* __restrict__ tidx,
                   const float* __restrict__ qloc, int MB, int V,
                   float* __restrict__ out) {
  extern __shared__ float s_q[];
  const int i = blockIdx.x;
  const float* qrow = qloc + static_cast<int64_t>(i) * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) s_q[v] = qrow[v];
  __syncthreads();
  const int t = tidx[i];
  const bool valid = t >= 0 && t < n_tiles;
  const int lane = threadIdx.x & 31;
  const float4* q4 = reinterpret_cast<const float4*>(s_q);
  for (int r = threadIdx.x >> 5; r < MB; r += kWarps) {
    float part = 0.0f;
    if (valid) {
      const char4* row = reinterpret_cast<const char4*>(
          dense + (static_cast<int64_t>(t) * MB + r) * V);
      for (int c = lane; c < V / 4; c += 32) {
        const char4 x = row[c];
        const float4 y = q4[c];
        part = fmaf(static_cast<float>(x.x), y.x, part);
        part = fmaf(static_cast<float>(x.y), y.y, part);
        part = fmaf(static_cast<float>(x.z), y.z, part);
        part = fmaf(static_cast<float>(x.w), y.w, part);
      }
    }
    part = warp_sum(part);
    if (lane == 0) out[static_cast<int64_t>(i) * MB + r] = part;
  }
}

__global__ void empty_kernel() {}

// Holds the stream for `ns` nanoseconds of the card's global timer, so that
// the launches the host queues behind it run back to back on the card.
__global__ void spin_kernel(unsigned long long ns) {
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while (t - t0 < ns);
}

int blocks_for(int64_t n, int per_block) {
  return static_cast<int>((n + per_block - 1) / per_block);
}

// K12 and K16: one launch of compare_lookup_kernel, 16-byte loads where
// W % 4 == 0 and comps and vals are 16-byte aligned
int compare_launch(const int* comps, const float* vals, const int* qc,
                   const float* qv, int T, int W, int Q, float* out,
                   cudaStream_t stream) {
  if (Q < 0 || Q > kMaxTerms) return static_cast<int>(cudaErrorInvalidValue);
  if (T > 0) {
    const int bits = compare_bits(Q);
    const size_t smem = (sizeof(int2) << bits) + Q * (sizeof(int) +
                                                      sizeof(float));
    const bool vec = W % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(comps) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(vals) % 16 == 0;
    const int blocks = blocks_for(T, kCmpWarps);
    if (vec) {
      compare_lookup_kernel<true><<<blocks, kCmpThreads, smem, stream>>>(
          comps, vals, qc, qv, T, W, Q, bits, out);
    } else {
      compare_lookup_kernel<false><<<blocks, kCmpThreads, smem, stream>>>(
          comps, vals, qc, qv, T, W, Q, bits, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrappers (ops/probe_kernels.py) hold the operands to these limits
// before a launch: K12's and K16's terms to kMaxTerms (their entry points
// refuse more too), K18's V to the 48 KB of dynamic shared memory a block
// gets without opting in, / 4.
extern "C" {

int seismic_probe_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

int seismic_probe_spin(unsigned long long ns, cudaStream_t stream) {
  spin_kernel<<<1, 1, 0, stream>>>(ns);
  return static_cast<int>(cudaGetLastError());
}

int seismic_probe_table_take(const float* table, int n_table, const int* idx,
                             int n, float* out, cudaStream_t stream) {
  if (n > 0) {
    // 16-byte loads of idx and stores of out where both are aligned
    const bool vec = reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int blocks =
        blocks_for((static_cast<int64_t>(n) + 3) / 4, kTakeThreads);
    if (vec) {
      table_take_kernel<true><<<blocks, kTakeThreads, 0, stream>>>(
          table, n_table, idx, n, out);
    } else {
      table_take_kernel<false><<<blocks, kTakeThreads, 0, stream>>>(
          table, n_table, idx, n, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int seismic_probe_row_gather(const float* src, int64_t n_rows, const int* idx,
                             int R, int W, float* out, cudaStream_t stream) {
  if (R > 0) {
    row_gather_kernel<false><<<blocks_for(R, kWarps), kThreads, 0, stream>>>(
        src, n_rows, idx, R, W, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int seismic_probe_flat_row_gather(const float* src, int64_t n_elems,
                                  const int* idx, int R, int W, float* out,
                                  cudaStream_t stream) {
  if (R > 0) {
    row_gather_kernel<true><<<blocks_for(R, kWarps), kThreads, 0, stream>>>(
        src, n_elems, idx, R, W, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int seismic_probe_compare_intersect(const int* comps, const float* vals,
                                    const int* qc, const float* qv, int T,
                                    int W, int Q, float* out,
                                    cudaStream_t stream) {
  return compare_launch(comps, vals, qc, qv, T, W, Q, out, stream);
}

int seismic_probe_compare_term_loop(const int* comps, const float* vals,
                                    const int* qc, const float* qv, int T,
                                    int W, int Q, float* out,
                                    cudaStream_t stream) {
  return compare_launch(comps, vals, qc, qv, T, W, Q, out, stream);
}

int seismic_probe_u8_matvec(const uint8_t* tile, const float* q,
                            const float* scale, int M, int K, float* out,
                            cudaStream_t stream) {
  if (M > 0) {
    // 16-byte loads where every row and q are 16-byte aligned: the vector
    // path is chosen by K as well as by the base pointers
    const bool vec = K % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(tile) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(q) % 16 == 0;
    const int blocks = blocks_for(M, kMvWarps);
    if (vec) {
      u8_matvec_kernel<true><<<blocks, kMvThreads, 0, stream>>>(
          tile, q, scale, M, K, out);
    } else {
      u8_matvec_kernel<false><<<blocks, kMvThreads, 0, stream>>>(
          tile, q, scale, M, K, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int seismic_probe_take_along_axis(const float* table, int R, int C,
                                  const int* idx, int64_t n, float* out,
                                  cudaStream_t stream) {
  if (n > 0) {
    const int64_t M = n / C;
    take_along_axis_kernel<<<blocks_for(M, kTaWarps), kTaThreads, 0,
                             stream>>>(table, R, C, idx, M, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int seismic_probe_i8_matmul(const int8_t* a, const float* b, int M, int K,
                            int N, float* out, cudaStream_t stream) {
  if (M > 0 && N > 0) {
    const dim3 grid(blocks_for(M, kMmM), blocks_for(N, kMmN));
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    i8_matmul_kernel<<<grid, kThreads, 0, stream>>>(a, b, M, K, N, out);
  }
  return static_cast<int>(cudaGetLastError());
}

int seismic_probe_tile_matvec(const int8_t* dense, int n_tiles,
                              const int* tidx, const float* qloc, int NS,
                              int MB, int V, float* out, cudaStream_t stream) {
  if (NS > 0) {
    tile_matvec_kernel<<<NS, kThreads, V * sizeof(float), stream>>>(
        dense, n_tiles, tidx, qloc, MB, V, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
