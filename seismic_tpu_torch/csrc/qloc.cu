// Per-pair query projection onto list vocabularies, fused with the per-pair
// int8 quantize; four entry points over one kernel.
//
// Replaces: seismic_tpu/ops/pallas_qloc.py::project_qloc_pallas (the
// pallas_call at :56), with the XLA quantize that follows it in
// seismic_tpu/search/grouped.py:763-771 (seismic_qloc_quantize) or without
// it, for the bf16/f32 scorer (seismic_qloc_f32, grouped.py:772-773);
// seismic_tpu/ops/pallas_qloc.py::project_qloc_rowmajor (the pallas_call at
// :127), the row-major projection with its in-kernel quantize
// (seismic_qloc_rowmajor: every pair brings its own vocab row and its own
// term row); and seismic_tpu/ops/pallas_qloc.py::project_qloc_residue (the
// pallas_call at :210), the residue-bucketed projection, quantized or not
// (seismic_qloc_residue, K9).
//
// Computes, for every (query, list) pair p,
//   qloc[p, v] = sum_i qv[t(p), i] * [vocab[l(p), v] == qc[t(p), i]]
//   scale[p]   = max(max_v |qloc[p, v]|, 1e-20) * f32(1 / 127)
//   q_i8[p, v] = round_half_even(qloc[p, v] / scale[p])
// with l(p) = pair_list[p], t(p) = p / QC for the first two entry points
// and l(p) = t(p) = p for the row-major one. The sum runs in term order
// from 0.0f, as the compare loop of the plain version adds it; a term id
// that appears more than once in a row sums its values in that order, and
// adding the 0.0f of a non-matching term changes no partial sum. So the
// int8 result equals the JAX chain bit for bit.
//
// K9 reads an index uploaded with vocab_residue = R: every list's
// vocabulary is R groups of VRS slots (group r holds the list's terms with
// term % R == r) and a spill region of V - R * VRS slots
// (ops/tiles_prep.py::residue_layout). A group slot v < R * VRS sums only
// the entries of bucket r = v / VRS of the row's residue buckets (qcb, qvb:
// R buckets of scb slots, -2 padded, search/grouped.py::_residue_buckets)
// whose id equals the code, in slot order; a spill slot sums the plain
// terms as above. Bucket ids below 0 are padding and never match.
//
// Bound on an H100: the bytes, each distinct vocab row once, the terms
// (and K9's buckets), the int8 [P, V] output and the scales (~0.05 ms at
// B=16384, P=229,376, V=512). A compare of every slot with every term
// (P * V * n_terms compare-adds, 0.136 ms of f32 operations there) is
// above that bound; a lookup does V per pair.
//
// Design: one block per query row of terms, serving that row's QC
// consecutive pairs (one warp for QC = 1, the row-major entry point). Warp
// 0 stages the row's real terms in shared memory by ballot compaction
// (qloc_common.cuh); every distinct term id then enters an
// open-addressed hash table in shared memory (term_table.cuh, which the
// fused rescore, rescore.cu, shares): 512 static slots up to 256 padded
// terms, and past them, in an instance of its own (kBig), a table in
// dynamic shared memory sized to the row's terms at a load factor <= 1/2;
// 8-byte entries of an int32
// key, PAD the empty key, which no staged term and no int16 code equals,
// and the f32 sum of the id's values in term order), one atomicCAS a
// term; only a row with a repeated id takes a second pass, in which the
// first of its terms sums the id's values in order. A warp per pair reads
// its V codes as 16-byte chunks of 8 (V % 8 == 0, as the TPU kernel asks),
// looks each up once (the first probes of a chunk's 8 codes issued
// together; about one 8-byte shared load a code at a load factor <= 1/8
// for 64 terms), keeps up to 1024 values in registers while it reduces
// the amax with shuffles, then quantizes and stores 8 codes a store.
// Wider rows look their remaining chunks up twice. A row of more terms
// than the largest table holds (8192) has no table: each code sums the
// row's matching terms, walked in order in device memory, into the same
// bits the table would give.
//
// The vocabulary is int16 (-1 padded) up to dim 32766 and int32
// (PAD_COMPONENT padded) past it, the JAX package's vocab16 / list_vocab
// (search/grouped.py:669-672, 705-710): the body is a template on the
// code type (Codes below). A chunk of 8 codes is one 16-byte load of
// int16 or two of int32, and the lookup is the same, since the table keys
// by int32: an int32 PAD code is the empty key, whose walk ends on an
// empty slot with value bits 0, so a padding slot reads 0.0f as the -1 of
// int16 does (no staged term is PAD: stage_terms drops it). The int32
// rows double the vocab bytes, the bound's largest term.
//
// K9 is the same body over one table of two kinds of key
// (qloc_residue_kernel). Warp 0 stages the row's plain terms and then its
// real bucket entries (id >= 0, so the -2 padding stays out), each in
// order, into one array under the key key(id, t) = id * 65536 + t: t = r
// for an entry of bucket r, t = R for a plain term (an id outside int16
// equals no code and stays out). R < 65535, so no two (id, t) share a
// key, and a plain key never equals a bucket key. One table of all those
// keys (dynamic shared memory, 2^bits slots from 512, a load factor <= 1/4
// for SC + R * scb keys where 16384 slots allow it, <= 1/2 at the most)
// is built from the array: most codes miss, and a miss walks on past
// every key in its way, so the table is kept sparse. Past that many keys
// (or R) the row is walked: a code of group r sums bucket r's matching
// entries, a spill code the plain terms, in order. VRS and V are multiples of
// 8, so a chunk of 8 codes lies wholly in one group r or wholly in the
// spill region: its lane looks up key(code, r), or key(code, R). A key
// holds its entries' values summed in order from 0.0f, which is the
// per-bucket compare loop's sum bit for bit, on any input.
//
// Why the R buckets' keys can stand for R compare loops: the key carries
// the bucket, and the upload and the buckets make it redundant.
// residue_permute_arrays puts code c only in group c % R (-1 padding the
// rest, which no bucket key equals), and _residue_buckets puts term c only
// in bucket c % R, in value order, position order kept within a residue.
// So a code of group r can only find entries of bucket r, and a repeated
// id sums in bucket order, its term order. A term that a full bucket
// dropped is in no bucket, so it gives 0 in the group slots; it is still
// a plain key, so it matches in the spill slots, as the plain version
// does. Keying by bucket costs one IMAD a code and keeps the kernel equal
// to the plain version on buckets that break that layout.
//
// K9 on an int32 vocabulary (dim past 32766, -1 padded after the residue
// permutation; qloc_residue_kernel<int>) keys the same table by the pair
// itself: id * 65536 + t is exact only for ids below 2^15, and the ids
// run to 2^31 - 2. An entry is 16 bytes, (int32 id, int32 tag, f32 value
// bits, unused): the 8-byte (id, tag) word is claimed by one 64-bit
// atomicCAS, the empty key is (-1, -1) (no staged tag is negative), and
// the slot is a multiplicative hash of id and tag. A probe is one 16-byte
// shared load that checks both words, so a lookup is exact for every id
// the upload holds, and the sums are the int16 instance's, term order
// kept. The plain terms are every id but PAD (a negative id matches the
// vocab's -1 as the plain version's compare does), the bucket entries
// the ids >= 0. The table has up to 8192 slots at twice the int16 bytes
// (128 KB, plus 12 bytes a staged key). Past 48 KB of dynamic shared
// memory each kernel is opted in once per device.

#include <cstdint>
#include <cuda_runtime.h>

#include "qloc_common.cuh"
#include "term_table.cuh"

namespace {

constexpr int kMaxWarps = kQlocThreads / 32;
constexpr int kHeld = 4;  // chunks of 8 codes whose values a lane keeps

// A chunk of 8 vocab codes of type T: one int4 of int16 codes, two of
// int32 codes; `load` reads chunk c of a row, `decode` widens to int32.
template <class T>
struct Codes;

template <>
struct Codes<int16_t> {
  int4 v;
  __device__ __forceinline__ static Codes load(const int16_t* row, int c) {
    return {reinterpret_cast<const int4*>(row)[c]};
  }
  __device__ __forceinline__ static Codes zero() {
    return {make_int4(0, 0, 0, 0)};
  }
  __device__ __forceinline__ void decode(int (&k)[8]) const { decode8(v, k); }
};

template <>
struct Codes<int32_t> {
  int4 a, b;
  __device__ __forceinline__ static Codes load(const int32_t* row, int c) {
    const int4* p = reinterpret_cast<const int4*>(row) + 2 * c;
    return {p[0], p[1]};
  }
  __device__ __forceinline__ static Codes zero() {
    return {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
  }
  __device__ __forceinline__ void decode(int (&k)[8]) const {
    k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
    k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
  }
};

__device__ __forceinline__ float amax8(const float (&x)[8], float m) {
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(x[j]));
  return m;
}

// chunk c's 8 outputs: f32 in two 16-byte stores when frow is given, else
// the int8 codes in one 8-byte store
__device__ __forceinline__ void store8(const float (&x)[8], float sc,
                                      int8_t* orow, float* frow, int c) {
  if (frow != nullptr) {
    float4* f = reinterpret_cast<float4*>(frow) + 2 * c;
    f[0] = make_float4(x[0], x[1], x[2], x[3]);
    f[1] = make_float4(x[4], x[5], x[6], x[7]);
    return;
  }
  unsigned u[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(
                     quantize(x[j], sc))) << (8 * (j & 3));
  }
  reinterpret_cast<uint2*>(orow)[c] = make_uint2(u[0], u[1]);
}

// K9's operands: the query rows' residue buckets and the vocabulary's
// group layout (R groups of VRS slots, then the spill region)
struct Buckets {
  const int* qcb;    // [B, R * scb], -2 padded
  const float* qvb;  // [B, R * scb]
  int R, scb, VRS;
  int bits;          // the table has 2^bits slots
};

// K9's tables: 2^bits slots, at a load factor <= 1/4 where the most slots
// allow and <= 1/2 at the most; past that the row is walked (bits 0)
constexpr int kResidueMaxBits = kTermMaxBits;      // 8-byte int16 keys
constexpr int kPairsMaxBits = kTermMaxBits - 1;    // 16-byte pairs
constexpr int kMinCode = -32768, kMaxCode = 32767;  // the int16 codes
// tags an int16 key holds: a bucket r < R, or R for the plain terms
constexpr int kMaxKeyTags = 65535;

// K9's keys: an int16 id c with a tag t < kMaxKeyTags, distinct for every
// (c, t) and never kTermEmpty (32767 * 65536 + 65535)
__device__ __forceinline__ int key_of(int c, int t) {
  return static_cast<int>(static_cast<unsigned>(c) * 65536u +
                          static_cast<unsigned>(t));
}

// K9 on int32 ids: the table of (id, tag) pairs (16-byte entries: id, tag,
// f32 value bits, unused), the empty pair (-1, -1)
constexpr unsigned long long kPairEmpty = ~0ull;

__device__ __forceinline__ unsigned long long pair_word(int c, int t) {
  return static_cast<unsigned>(c) |
         (static_cast<unsigned long long>(static_cast<unsigned>(t)) << 32);
}

__device__ __forceinline__ int pair_slot(int c, int t, int bits) {
  const unsigned h = static_cast<unsigned>(c) * 2654435761u ^
                     static_cast<unsigned>(t + 1) * 0x27d4eb2du;
  return static_cast<int>((h * 2654435761u) >> (32 - bits));
}

// Order-keeping compaction by the calling warp of the entries i < n of row
// `row` of (ids, vals) whose id passes `keep`: (id, tag_of(i)) and the
// value land in s_key / s_val in entry order. Returns their count.
template <class Keep, class TagOf>
__device__ __forceinline__ int stage_pairs(const int* __restrict__ ids,
                                           const float* __restrict__ vals,
                                           int64_t row, int n, Keep keep,
                                           TagOf tag_of, int2* s_key,
                                           float* s_val) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const int c = i < n ? ids[row * n + i] : 0;
    const bool real = i < n && keep(c);
    const unsigned mask = __ballot_sync(0xffffffffu, real);
    if (real) {
      const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
      s_key[pos] = make_int2(c, tag_of(i));
      s_val[pos] = vals[row * n + i];
    }
    cnt += __popc(mask);
  }
  return cnt;
}

// Enter the n staged pairs, one 64-bit atomicCAS a pair, and, where a pair
// repeats, sum its values in entry order in a second pass (as
// term_table_build does for int32 keys); every slot was cleared to the
// empty pair with value bits 0 and *s_dup to 0 before the caller's
// barrier. Returns after the block's last __syncthreads.
__device__ __forceinline__ void pair_table_build(int4* s_tab,
                                                 const int2* s_key,
                                                 const float* s_val, int n,
                                                 int* s_dup, int bits) {
  const int tid = threadIdx.x;
  const int mask = (1 << bits) - 1;
  for (int i = tid; i < n; i += blockDim.x) {
    const int2 k = s_key[i];
    const unsigned long long w = pair_word(k.x, k.y);
    int h = pair_slot(k.x, k.y, bits);
    while (true) {
      const unsigned long long prev = atomicCAS(
          reinterpret_cast<unsigned long long*>(&s_tab[h]), kPairEmpty, w);
      if (prev == kPairEmpty) {
        s_tab[h].z = __float_as_int(__fadd_rn(0.0f, s_val[i]));
        break;
      }
      if (prev == w) {
        *s_dup = 1;
        break;
      }
      h = (h + 1) & mask;
    }
  }
  __syncthreads();
  if (*s_dup) {
    for (int i = tid; i < n; i += blockDim.x) {
      const int2 k = s_key[i];
      bool first = true;
      for (int j = 0; j < i && first; ++j) {
        first = s_key[j].x != k.x || s_key[j].y != k.y;
      }
      if (!first) continue;
      float sum = 0.0f;
      for (int j = i; j < n; ++j) {
        if (s_key[j].x == k.x && s_key[j].y == k.y) sum += s_val[j];
      }
      int h = pair_slot(k.x, k.y, bits);
      while (s_tab[h].x != k.x || s_tab[h].y != k.y) h = (h + 1) & mask;
      s_tab[h].z = __float_as_int(sum);
    }
    __syncthreads();
  }
}

// The summed values of the 8 pairs (c[j], t) (0.0f for a pair the table
// lacks: the walk ends on the empty pair, whose value bits are 0); the
// first probes of all 8 are issued together.
__device__ __forceinline__ void lookup8_pair(const int4* s_tab,
                                             const int (&c)[8], int t,
                                             float (&x)[8], int bits) {
  const int mask = (1 << bits) - 1;
  int h[8];
  int4 e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    h[j] = pair_slot(c[j], t, bits);
    e[j] = s_tab[h[j]];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    while ((e[j].x != c[j] || e[j].y != t) && e[j].y != -1) {
      h[j] = (h[j] + 1) & mask;
      e[j] = s_tab[h[j]];
    }
    x[j] = e[j].x == c[j] && e[j].y == t ? __int_as_float(e[j].z) : 0.0f;
  }
}

// The kernels' body: a block per query row; lane l of a pair's warp holds
// chunks l + 32 i, i < kHeldN.
template <bool kResidue, int kHeldN, class T, bool kBig = false>
__device__ __forceinline__ void qloc_body(
    const T* __restrict__ vocab,        // [n_lists, V] or [P, V]
    const int* __restrict__ pair_list,  // [P], or null: row p
    const int* __restrict__ qc,         // [B, SC] or [P, SC]
    const float* __restrict__ qv,       // same shape as qc
    int V, int SC, int QC,              // QC 1: one term row a pair
    int8_t* __restrict__ out,           // [P, V]
    float* __restrict__ scale,          // [P]
    float* __restrict__ out_f32,        // [P, V], or null: quantize
    const Buckets& bk) {                // K9 only
  // K1 / K8 up to kTermStaticTerms terms (kStatic): the staged terms and
  // the 512-slot table, static. Else dynamic: the table of 2^bits slots
  // (K1 past them: term_bits(SC); K9: bk.bits), then the row's staged
  // keys and values (K1: SC; K9: SC + R * scb; on int32 ids the table of
  // pairs and the staged pairs). bits 0: no table, the row's terms (and
  // K9's buckets) are walked in device memory.
  constexpr bool kPairs = kResidue && sizeof(T) == 4;
  constexpr bool kStatic = !kResidue && !kBig;
  __shared__ int s_qc1[kStatic ? kTermStaticTerms : 1];
  __shared__ float s_qv1[kStatic ? kTermStaticTerms : 1];
  __shared__ int2 s_tab1[kStatic ? kTermSlots : 1];
  __shared__ int s_n;
  __shared__ int s_dup;  // some key repeats in the row
  extern __shared__ __align__(16) int2 s_dyn[];
  const int bits = kStatic    ? kTermBits
                   : kResidue ? bk.bits
                              : (SC > kTableMaxTerms ? 0 : term_bits(SC));
  const bool walk = !kStatic && bits == 0;
  const int n_keys = SC + bk.R * bk.scb;
  int2* s_tab = kStatic ? s_tab1 : s_dyn;  // (key, f32 value bits)
  int* s_qc = kStatic ? s_qc1 : reinterpret_cast<int*>(s_dyn + (1 << bits));
  float* s_qv = kStatic ? s_qv1 : reinterpret_cast<float*>(s_qc + n_keys);
  int4* s_ptab = reinterpret_cast<int4*>(s_dyn);  // kPairs only
  int2* s_pkey = reinterpret_cast<int2*>(s_ptab + (1 << bits));
  float* s_pval = reinterpret_cast<float*>(s_pkey + n_keys);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (walk) {
    // nothing to build
  } else if constexpr (kPairs) {
    for (int i = tid; i < (1 << bits); i += blockDim.x) {
      s_ptab[i] = make_int4(-1, -1, 0, 0);
    }
    if (tid == 0) s_dup = 0;
    // the plain terms as (id, R), then the bucket entries as (id, r)
    if (tid < 32) {
      const int R = bk.R, scb = bk.scb;
      const int n = stage_pairs(
          qc, qv, b, SC, [](int c) { return c != kQlocPad; },
          [R](int) { return R; }, s_pkey, s_pval);
      const int nb = stage_pairs(
          bk.qcb, bk.qvb, b, R * scb, [](int c) { return c >= 0; },
          [scb](int i) { return i / scb; }, s_pkey + n, s_pval + n);
      if (tid == 0) s_n = n + nb;
    }
    __syncthreads();
    pair_table_build(s_ptab, s_pkey, s_pval, s_n, &s_dup, bits);
  } else {
    term_table_clear(s_tab, &s_dup, bits);
    if constexpr (kResidue) {
      // the plain terms under key(id, R), then the bucket entries under
      // key(id, r); ids outside int16 equal no code and stay out
      if (tid < 32) {
        const int R = bk.R, scb = bk.scb;
        const int n = stage_row(
            qc, qv, b, SC,
            [R](int, int c) {
              return c >= kMinCode && c <= kMaxCode ? key_of(c, R) : kQlocPad;
            },
            s_qc, s_qv);
        const int nb = stage_row(
            bk.qcb, bk.qvb, b, R * scb,
            [scb](int i, int c) {
              return c >= 0 && c <= kMaxCode ? key_of(c, i / scb) : kQlocPad;
            },
            s_qc + n, s_qv + n);
        if (tid == 0) s_n = n + nb;
      }
    } else {
      stage_terms(qc, qv, b, SC, s_qc, s_qv, &s_n);
    }
    __syncthreads();
    term_table_build(s_tab, s_qc, s_qv, s_n, &s_dup, bits);
  }

  // chunk c's tag: its group r, or R in the spill region
  const int n_group = kResidue ? bk.R * bk.VRS : 0;
  auto tag_of = [&](int c) {
    return 8 * c < n_group ? 8 * c / bk.VRS : bk.R;
  };
  // Without a table: the values of the 8 codes k, each the sum in order
  // from 0.0f of the entries equal to it among K9's bucket `tag` (ids >=
  // 0) or, in the spill region and in K1 / K8, the row's plain terms (not
  // PAD): what the table's keys hold, bit for bit.
  auto walk8 = [&](int tag, const int (&k)[8], float (&x)[8]) {
    const bool bucket = kResidue && tag < bk.R;
    const int64_t at = bucket ? (static_cast<int64_t>(b) * bk.R + tag) *
                                    bk.scb
                              : static_cast<int64_t>(b) * SC;
    const int* ids = (bucket ? bk.qcb : qc) + at;
    const float* vals = (bucket ? bk.qvb : qv) + at;
    const int n = bucket ? bk.scb : SC;
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const int c = __ldg(ids + i);
      if (bucket ? c < 0 : c == kQlocPad) continue;
      const float v = __ldg(vals + i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (k[j] == c) x[j] = __fadd_rn(x[j], v);
      }
    }
  };
  // chunk c's 8 values: its codes' keys looked up, key(code, tag) for K9
  auto find8 = [&](int tag, const Codes<T>& chunk, float (&x)[8]) {
    int k[8];
    chunk.decode(k);
    if (walk) {
      walk8(tag, k, x);
      return;
    }
    if constexpr (kPairs) {
      lookup8_pair(s_ptab, k, tag, x, bits);
      return;
    }
    if constexpr (kResidue) {
#pragma unroll
      for (int j = 0; j < 8; ++j) k[j] = key_of(k[j], tag);
    }
    lookup8(s_tab, k, x, bits);
  };

  // a warp per pair; lane l holds the values of chunks l + 32 i (i <
  // kHeldN) of 8 codes in registers from the lookup to the store, and looks
  // up any chunk past them (V > 256 kHeldN) again for the store
  const int lane = tid & 31;
  const int nch = V / 8;
  int tags[kHeldN];  // the same chunks for every pair of the row (K9)
#pragma unroll
  for (int i = 0; i < kHeldN; ++i) tags[i] = tag_of(lane + 32 * i);
  for (int j = tid >> 5; j < QC; j += blockDim.x >> 5) {
    const int64_t p = static_cast<int64_t>(b) * QC + j;
    const int64_t vr = pair_list != nullptr ? pair_list[p] : p;
    const T* vrow = vocab + vr * V;
    int8_t* orow = out_f32 == nullptr ? out + p * V : nullptr;
    float* frow = out_f32 == nullptr ? nullptr : out_f32 + p * V;
    Codes<T> held[kHeldN];
#pragma unroll
    for (int i = 0; i < kHeldN; ++i) {
      const int c = lane + 32 * i;
      held[i] = c < nch ? Codes<T>::load(vrow, c) : Codes<T>::zero();
    }
    float xs[kHeldN][8];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < kHeldN; ++i) {
      if (lane + 32 * i < nch) {
        find8(tags[i], held[i], xs[i]);
        amax = amax8(xs[i], amax);
        if (frow != nullptr) store8(xs[i], 0.0f, orow, frow, lane + 32 * i);
      }
    }
    for (int c = lane + 32 * kHeldN; c < nch; c += 32) {
      float x[8];
      find8(tag_of(c), Codes<T>::load(vrow, c), x);
      amax = amax8(x, amax);
      if (frow != nullptr) store8(x, 0.0f, orow, frow, c);
    }
    if (frow != nullptr) continue;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    }
    const float sc = quant_scale(amax);
    if (lane == 0) scale[p] = sc;
#pragma unroll
    for (int i = 0; i < kHeldN; ++i) {
      if (lane + 32 * i < nch) store8(xs[i], sc, orow, frow, lane + 32 * i);
    }
    for (int c = lane + 32 * kHeldN; c < nch; c += 32) {
      float x[8];
      find8(tag_of(c), Codes<T>::load(vrow, c), x);
      store8(x, sc, orow, frow, c);
    }
  }
}

#define QLOC_PARAMS                                                     \
  const T* __restrict__ vocab, const int* __restrict__ pair_list,        \
      const int* __restrict__ qc, const float* __restrict__ qv, int V,  \
      int SC, int QC, int8_t* __restrict__ out, float* __restrict__ scale, \
      float* __restrict__ out_f32, Buckets bk
#define QLOC_ARGS vocab, pair_list, qc, qv, V, SC, QC, out, scale, out_f32, bk

// kBig: a row of more than kTermStaticTerms terms (its table sized at run
// time, or walked), an instance of its own, so the one of every main path
// keeps its static table and compile-time hash
template <class T, bool kBig>
__global__ void __launch_bounds__(kQlocThreads) qloc_kernel(QLOC_PARAMS) {
  qloc_body<false, kHeld, T, kBig>(QLOC_ARGS);
}

// K9 keeps more in registers than K1 (its chunks' tags, the key
// arithmetic): left to itself ptxas gives it more than 64 registers;
// capped for 4 blocks of 8 warps an SM, a lane holds 2 chunks (all that a
// row of V <= 512 has) and looks the rest of a wider row up again.
constexpr int kResidueBlocks = 4;
constexpr int kResidueHeld = 2;

template <class T>
__global__ void __launch_bounds__(kQlocThreads, kResidueBlocks)
    qloc_residue_kernel(QLOC_PARAMS) {
  qloc_body<true, kResidueHeld, T>(QLOC_ARGS);
}

template <bool kResidue, class T>
int launch(const T* vocab, const int* pair_list, const int* qc,
           const float* qv, int P, int V, int SC, int QC, int8_t* out,
           float* scale, float* out_f32, const Buckets& bk,
           cudaStream_t stream) {
  if (V % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P > 0) {
    // QC pairs on as few rounds of at most 8 warps as they need
    const int rounds = (QC + kMaxWarps - 1) / kMaxWarps;
    const int warps = (QC + rounds - 1) / rounds;
    const dim3 grid(P / QC), block(warps * 32);
    // the table, then the staged keys and values (K9 on int32 ids:
    // 16-byte entries and 12 bytes a staged pair); none for a walked row.
    // Past 48 KB each instance is opted in once per device to the most
    // any row takes (kTermMaxSmem bounds all three layouts).
    static bool opted[kMaxDevices];
    size_t smem = 0;
    auto kernel = qloc_kernel<T, false>;
    if constexpr (kResidue) {
      constexpr bool pairs = sizeof(T) == 4;
      smem = bk.bits == 0
                 ? 0
                 : ((pairs ? sizeof(int4) : sizeof(int2)) << bk.bits) +
                       static_cast<size_t>(SC + bk.R * bk.scb) *
                           (pairs ? 12 : 8);
      kernel = qloc_residue_kernel<T>;
    } else if (SC > kTermStaticTerms) {
      smem = term_smem(SC);
      kernel = qloc_kernel<T, true>;
    }
    if (smem > 48 * 1024) {
      const cudaError_t e = opt_in_smem(kernel, kTermMaxSmem, opted);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<grid, block, smem, stream>>>(QLOC_ARGS);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr Buckets kNoBuckets = {nullptr, nullptr, 0, 0, 0, 0};

#undef QLOC_PARAMS
#undef QLOC_ARGS

}  // namespace

extern "C" {


// K1 over vocab [n_lists, V] of vocab_bytes 2 (int16, -1 padded) or 4
// (int32, PAD_COMPONENT padded); qc / qv [B, SC], P = B * QC
int seismic_qloc_quantize(const void* vocab, int vocab_bytes,
                          const int* pair_list, const int* qc,
                          const float* qv, int P, int V, int SC, int QC,
                          int8_t* out, float* scale, cudaStream_t stream) {
  if (vocab_bytes == 4) {
    return launch<false>(static_cast<const int32_t*>(vocab), pair_list, qc,
                         qv, P, V, SC, QC, out, scale, nullptr, kNoBuckets,
                         stream);
  }
  return launch<false>(static_cast<const int16_t*>(vocab), pair_list, qc,
                       qv, P, V, SC, QC, out, scale, nullptr, kNoBuckets,
                       stream);
}

// the same projection, unquantized: out f32 [P, V]
int seismic_qloc_f32(const void* vocab, int vocab_bytes,
                     const int* pair_list, const int* qc, const float* qv,
                     int P, int V, int SC, int QC, float* out,
                     cudaStream_t stream) {
  if (vocab_bytes == 4) {
    return launch<false>(static_cast<const int32_t*>(vocab), pair_list, qc,
                         qv, P, V, SC, QC, nullptr, nullptr, out,
                         kNoBuckets, stream);
  }
  return launch<false>(static_cast<const int16_t*>(vocab), pair_list, qc,
                       qv, P, V, SC, QC, nullptr, nullptr, out, kNoBuckets,
                       stream);
}

// row-major (K8): vocab_rows [P, V] of vocab_bytes 2 or 4, qc / qv
// [P, SC], one row each a pair
int seismic_qloc_rowmajor(const void* vocab_rows, int vocab_bytes,
                          const int* qc, const float* qv, int P, int V,
                          int SC, int8_t* out, float* scale,
                          cudaStream_t stream) {
  if (vocab_bytes == 4) {
    return launch<false>(static_cast<const int32_t*>(vocab_rows), nullptr,
                         qc, qv, P, V, SC, 1, out, scale, nullptr,
                         kNoBuckets, stream);
  }
  return launch<false>(static_cast<const int16_t*>(vocab_rows), nullptr, qc,
                       qv, P, V, SC, 1, out, scale, nullptr, kNoBuckets,
                       stream);
}

// K9: vocab residue-ordered (R groups of VRS slots, then the spill) of
// vocab_bytes 2 (int16) or 4 (int32), -1 padded; qcb / qvb [B, R * scb].
// out_f32 null: int8 out [P, V] + scale [P]; else the f32 projection.
// V % 8 == 0, VRS % 8 == 0, R * VRS <= V; any SC, R and scb.
int seismic_qloc_residue(const void* vocab, int vocab_bytes,
                         const int* pair_list,
                         const int* qcb, const float* qvb, const int* qc,
                         const float* qv, int P, int V, int SC, int QC,
                         int R, int scb, int VRS, int8_t* out, float* scale,
                         float* out_f32, cudaStream_t stream) {
  if (R <= 0 || scb <= 0 || VRS < 0 || VRS % 8 != 0 ||
      static_cast<int64_t>(R) * VRS > V) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a load factor <= 1/4 for SC plain terms and R * scb bucket entries
  // where the most slots allow, <= 1/2 at the most; past that (or past
  // the tags an int16 key holds) the row is walked (bits 0)
  const int64_t keys = static_cast<int64_t>(SC) + static_cast<int64_t>(R) *
                                                      scb;
  const int max_bits = vocab_bytes == 4 ? kPairsMaxBits : kResidueMaxBits;
  int bits = kTermBits;
  while (bits < max_bits && (int64_t{1} << bits) < 4 * keys) ++bits;
  if ((int64_t{1} << bits) < 2 * keys ||
      (vocab_bytes != 4 && R >= kMaxKeyTags)) {
    bits = 0;
  }
  const Buckets bk = {qcb, qvb, R, scb, VRS, bits};
  if (vocab_bytes == 4) {
    return launch<true>(static_cast<const int32_t*>(vocab), pair_list, qc,
                        qv, P, V, SC, QC, out, scale, out_f32, bk, stream);
  }
  return launch<true>(static_cast<const int16_t*>(vocab), pair_list, qc, qv,
                      P, V, SC, QC, out, scale, out_f32, bk, stream);
}

}  // extern "C"
