// Per-(query, list) pair doc-tile scorer of the engine path.
//
// Replaces: seismic_tpu/ops/pallas_tiles.py::score_tiles_pallas (the
// pallas_call at :88), the fused scorer behind
// seismic_tpu/search/engine.py::_tiles_search.
//
// For pair p whose list's region starts at subtile s_p = region_start[p]
// (128-row units of the aligned tile layout) and row r < ll_pad:
//   out[p, r] = tile_scale[s_p*128 + r]
//               * sum_v f32(u8 tiles[s_p*128 + r, v]) * qloc[p, v]
// The 128-row subtiles that start at or past pair_len[p], the list's
// length, are not read for p and its outputs there are 0; the TPU kernel
// streams all ll_pad rows, and its caller masks the rows past the length
// as this one's does.
//
// Bound on an H100: bytes, each distinct subtile (128 * V bytes and its
// scales) read once for all the pairs of the batch that share it, plus
// every pair's qloc row and output row, at 3.35 TB/s (1.34 ms at the
// engine cell: 57,344 pairs, V 1024, ~31K distinct subtiles). The f32
// products (2 * 128 * V a live (pair, subtile)) are half of that at the
// CUDA cores' rate. A schedule of one block a (pair, subtile) streams and
// converts each distinct subtile once a pair that reads it, ~5x over.
//
// Design: the wrapper groups the pairs by list on the device, in a few
// torch operations and no host synchronisation
// (ops/tiles_scorer.py::group_pairs_by_region): a stable sort by
// region_start, cut every kM = 16 pairs of one list, each group's first
// place in the sorted order listed, the group count in device memory. A
// persistent grid (as many 256-thread blocks as fit on the card, 3 an SM)
// takes the groups in order from a counter, so that the blocks running at
// one time share a list's subtiles in L2 and a block that drew short
// groups takes more. Warp 0 reads a group's pairs, their lengths and the
// span (the largest length); the block scores the group's subtiles below
// the span one after another. A subtile's [128, V] u8 bytes stream in
// once, in 64-column slices through a 4-stage cp.async ring whose rows
// sit 80 bytes apart (so the 8 lanes of a 16-byte shared load hit 8
// distinct bank quads), with the group's qloc slices [m, 64] f32 beside
// them. Each byte is converted once for the group, exactly, by
// __byte_perm into the mantissa of 2^23 (0x4B0000xx) and one FADD of
// -2^23: two ALU operations instead of an I2F, whose pipe issues 16 a
// clock an SM. Thread (quarter
// q = warp % 4, half h = warp / 4, lane) owns rows h * 64 + lane and + 32
// over the slice's columns 16 q .. 16 q + 15, and accumulates them
// against all m pairs of the group (a 2-row x m register tile; q values
// are warp-uniform shared loads, so they broadcast, and a warp skips the
// FMAs of a pair's four columns that are all 0, as most of a projection
// is). The code is instantiated for m = 1, 2, 3, 4 and for 8 and 16 with
// a uniform guard on the upper half, so a group pays the FMAs of its own
// pairs only. The four quarters' sums meet in shared memory (aliasing the
// ring), are scaled by the row's tile_scale and written row by row,
// coalesced, into the zeroed output: the subtiles past a pair's own
// length, and those past its group's span, are never written or read.

#include <cstdint>
#include <cuda_runtime.h>

#include "grouped_i8_mma.cuh"  // cp.async helpers, opt_in_smem

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 128;     // rows per subtile
constexpr int kM = 16;        // pairs a group holds at most
constexpr int kSlice = 64;    // columns of a ring stage
constexpr int kPitch = 80;    // bytes between a stage's rows (16 * odd)
constexpr int kRing = 4;      // ring stages
constexpr int kTileBytes = kSub * kPitch;           // 10,240
constexpr int kQBytes = kM * kSlice * 4;            // 4,096
constexpr int kStageBytes = kTileBytes + kQBytes;   // 14,336
constexpr int kRedBytes = 4 * kM * kSub * 4;        // 32,768
constexpr int kSmem = kRing * kStageBytes > kRedBytes ? kRing * kStageBytes
                                                      : kRedBytes;

// 16 bytes from src, or zeros past V (bytes = 0 reads nothing)
__device__ __forceinline__ void cp_async16_zfill(unsigned dst,
                                                 const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// byte j of w as an exact f32: 2^23 + byte, less 2^23
__device__ __forceinline__ float u8f(unsigned w, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | j)),
                   8388608.0f);
}

struct Item {
  const uint8_t* tiles;  // the subtile's first row
  const float* qloc;     // [P, V]
  const int* pid;        // shared [kM], the group's pairs
  int m;
  int V;
};

// The plain-load twin of load_slice for a V whose rows are not 16-byte
// aligned (cp.async needs the alignment of its size): the same chunks,
// read a byte (a float) at a time, zeros past V, stored to the stage.
__device__ __forceinline__ void load_slice_bytes(const Item& it,
                                                 uint8_t* st, int col0) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kSub * 4; i += kThreads) {
    const int r = i >> 2;
    const int col = col0 + (i & 3) * 16;
    const uint8_t* src = it.tiles + static_cast<int64_t>(r) * it.V;
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (col + e < it.V) w[e >> 2] |= static_cast<unsigned>(src[col + e])
                                       << (8 * (e & 3));
    }
    *reinterpret_cast<uint4*>(st + r * kPitch + (i & 3) * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  const int p = tid >> 4;
  if (p < it.m) {
    const int col = col0 + (tid & 15) * 4;
    const float* src = it.qloc + static_cast<int64_t>(it.pid[p]) * it.V;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = col + e < it.V ? src[col + e] : 0.0f;
    *reinterpret_cast<float4*>(st + kTileBytes + p * (kSlice * 4) +
                               (tid & 15) * 16) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// Stage slice ks of the subtile and of the group's qloc rows into ring
// stage ks % kRing: 512 16-byte tile chunks and m * 16 qloc chunks.
// kVec: V % 16 == 0 and both bases 16-byte aligned, so cp.async; else
// the plain loads of load_slice_bytes (an instance of its own, so the
// aligned one carries none of it).
template <bool kVec>
__device__ __forceinline__ void load_slice(const Item& it, uint8_t* smem,
                                           int ks) {
  uint8_t* st = smem + (ks % kRing) * kStageBytes;
  const int tid = threadIdx.x;
  const int col0 = ks * kSlice;
  if constexpr (!kVec) {
    load_slice_bytes(it, st, col0);
    return;
  }
#pragma unroll
  for (int i = tid; i < kSub * 4; i += kThreads) {
    const int r = i >> 2;
    const int col = col0 + (i & 3) * 16;
    const bool in = col < it.V;
    cp_async16_zfill(smem_addr(st + r * kPitch + (i & 3) * 16),
                     in ? it.tiles + static_cast<int64_t>(r) * it.V + col
                        : it.tiles,
                     in ? 16 : 0);
  }
  const int p = tid >> 4;
  if (p < it.m) {
    const int col = col0 + (tid & 15) * 4;
    const bool in = col < it.V;
    cp_async16_zfill(
        smem_addr(st + kTileBytes + p * (kSlice * 4) + (tid & 15) * 16),
        in ? it.qloc + static_cast<int64_t>(it.pid[p]) * it.V + col
           : it.qloc,
        in ? 16 : 0);
  }
}

// The item's dot products, quarter q's share, into red[q][p][row] (red
// aliases the ring; the function ends synchronised).
template <int MB, bool kVec>
__device__ __forceinline__ void score_item(const Item& it, uint8_t* smem) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = warp & 3;
  const int ra = (warp >> 2) * 64 + lane;
  const int rb = ra + 32;
  const int m = it.m;
  const int nk = (it.V + kSlice - 1) / kSlice;
  float acc_a[MB], acc_b[MB];
#pragma unroll
  for (int p = 0; p < MB; ++p) acc_a[p] = acc_b[p] = 0.0f;

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < nk) load_slice<kVec>(it, smem, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<kRing - 2>();  // this thread's copies of slice ks landed
    __syncthreads();  // ... every thread's; and slice ks - 1 is consumed
    if (ks + kRing - 1 < nk) load_slice<kVec>(it, smem, ks + kRing - 1);
    cp_async_commit();
    const uint8_t* st = smem + (ks % kRing) * kStageBytes;
    const float* sq = reinterpret_cast<const float*>(st + kTileBytes);
    const uint4 wa =
        *reinterpret_cast<const uint4*>(st + ra * kPitch + q * 16);
    const uint4 wb =
        *reinterpret_cast<const uint4*>(st + rb * kPitch + q * 16);
    const unsigned xa[4] = {wa.x, wa.y, wa.z, wa.w};
    const unsigned xb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float fa[4], fb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fa[e] = u8f(xa[j], e);
        fb[e] = u8f(xb[j], e);
      }
#pragma unroll
      for (int p = 0; p < MB; ++p) {
        // the upper half of the 8 and 16 variants holds empty slots
        if (MB <= 4 || p < MB / 2 || p < m) {
          const float4 v = *reinterpret_cast<const float4*>(
              sq + p * kSlice + q * 16 + 4 * j);
          // most of a projection is 0 (a list's vocabulary against a
          // query's terms): a warp shares v, so this skip is uniform
          if ((__float_as_uint(v.x) | __float_as_uint(v.y) |
               __float_as_uint(v.z) | __float_as_uint(v.w)) == 0u) {
            continue;
          }
          acc_a[p] = fmaf(fa[0], v.x, acc_a[p]);
          acc_a[p] = fmaf(fa[1], v.y, acc_a[p]);
          acc_a[p] = fmaf(fa[2], v.z, acc_a[p]);
          acc_a[p] = fmaf(fa[3], v.w, acc_a[p]);
          acc_b[p] = fmaf(fb[0], v.x, acc_b[p]);
          acc_b[p] = fmaf(fb[1], v.y, acc_b[p]);
          acc_b[p] = fmaf(fb[2], v.z, acc_b[p]);
          acc_b[p] = fmaf(fb[3], v.w, acc_b[p]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the quarters' sums
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int p = 0; p < MB; ++p) {
    if (MB <= 4 || p < MB / 2 || p < m) {
      red[(q * kM + p) * kSub + ra] = acc_a[p];
      red[(q * kM + p) * kSub + rb] = acc_b[p];
    }
  }
  __syncthreads();
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
score_tiles_kernel(const uint8_t* __restrict__ tiles,      // [rows, V]
                   const float* __restrict__ tile_scale,   // [rows]
                   const float* __restrict__ qloc,         // [P, V]
                   const int* __restrict__ pair_len,       // [P]
                   const int64_t* __restrict__ order,      // [P]
                   const int* __restrict__ region,         // [P], sorted
                   const int64_t* __restrict__ first,      // [P + 1]
                   const int64_t* __restrict__ n_groups,   // [1]
                   int* __restrict__ next_group,           // [1], 0
                   int V, int n_sub,
                   float* __restrict__ out) {  // [P, n_sub * 128], zeroed
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_pid[kM];
  __shared__ int s_len[kM];
  __shared__ int s_m;
  __shared__ int s_region;
  __shared__ int s_span;
  __shared__ int s_g;
  const int tid = threadIdx.x;
  const int ll_pad = n_sub * kSub;
  const int n = static_cast<int>(*n_groups);
  if (tid == 0) s_g = atomicAdd(next_group, 1);
  __syncthreads();
  int g = s_g;
  while (g < n) {
    // warp 0 reads the group's header: its pairs, their lengths, its
    // region, its span (the largest length), and takes the block's next
    // group, which it needs only at the end
    int next = 0;
    if (tid < 32) {
      const int64_t f = first[g];
      const int m = static_cast<int>(first[g + 1] - f);
      int pid = -1, len = 0;
      if (tid < m) {
        pid = static_cast<int>(order[f + tid]);
        len = pair_len[pid];
      }
      int span = len;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        span = max(span, __shfl_xor_sync(0xffffffffu, span, off));
      }
      if (tid < kM) {
        s_pid[tid] = pid;
        s_len[tid] = len;
      }
      if (tid == 0) {
        s_m = m;
        s_region = region[f];
        s_span = span;
        next = atomicAdd(next_group, 1);
      }
    }
    __syncthreads();
    const int m = s_m;
    // the group's subtiles below its span, one after another
    for (int s = 0; s < n_sub && s * kSub < s_span; ++s) {
      const int64_t row0 = (static_cast<int64_t>(s_region) + s) * kSub;
      const Item it{tiles + row0 * V, qloc, s_pid, m, V};
      switch (m) {
        case 1: score_item<1, kVec>(it, smem); break;
        case 2: score_item<2, kVec>(it, smem); break;
        case 3: score_item<3, kVec>(it, smem); break;
        case 4: score_item<4, kVec>(it, smem); break;
        default:
          if (m <= 8) {
            score_item<8, kVec>(it, smem);
          } else {
            score_item<16, kVec>(it, smem);
          }
      }
      // row r of pair p: the four quarters' sum, scaled; a pair whose own
      // length ends before the subtile keeps the 0 the wrapper wrote
      const float* red = reinterpret_cast<const float*>(smem);
      for (int j = tid; j < m * kSub; j += kThreads) {
        const int p = j / kSub;
        const int r = j % kSub;
        if (s * kSub < s_len[p]) {
          const float sum = ((red[(0 * kM + p) * kSub + r] +
                              red[(1 * kM + p) * kSub + r]) +
                             red[(2 * kM + p) * kSub + r]) +
                            red[(3 * kM + p) * kSub + r];
          out[static_cast<int64_t>(s_pid[p]) * ll_pad + s * kSub + r] =
              __fmul_rn(sum, tile_scale[row0 + r]);
        }
      }
      __syncthreads();  // the next subtile reuses the ring
    }
    if (tid == 0) s_g = next;
    __syncthreads();
    g = s_g;
    // every warp has read s_g and the header before warp 0 rewrites them
    __syncthreads();
  }
}

// the persistent grid of instance kVec: as many blocks as fit, each
// instance opted in to its shared memory once per device
template <bool kVec>
int launch(const uint8_t* tiles, const float* tile_scale, const float* qloc,
           const int* pair_len, const int64_t* order, const int* region,
           const int64_t* first, const int64_t* n_groups, int* next_group,
           int V, int n_sub, float* out, cudaStream_t stream) {
  static bool opted[kMaxDevices];
  static int grids[kMaxDevices];
  auto kernel = score_tiles_kernel<kVec>;
  cudaError_t e = opt_in_smem(kernel, kSmem, opted);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int grid = dev < kMaxDevices ? grids[dev] : 0;
  if (grid == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmem);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    grid = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) grids[dev] = grid;
  }
  kernel<<<grid, kThreads, kSmem, stream>>>(
      tiles, tile_scale, qloc, pair_len, order, region, first, n_groups,
      next_group, V, n_sub, out);
  return 0;
}

}  // namespace

extern "C" {

int seismic_score_tiles_group_pairs() { return kM; }

// tiles u8 [rows, V]; tile_scale f32 [rows]; qloc f32 [P, V]; pair_len
// int32 [P]; the grouping: order int64 [P] (the pairs stably sorted by
// region), region int32 [P] (their region starts in that order), first
// int64 [P + 1] (group g is order[first[g]:first[g + 1]], at most 16
// pairs) and n_groups int64 [1]; next_group int32 [1], zeroed; out f32
// [P, n_sub * 128], zeroed. Any V >= 1: the ring holds 64 columns a stage
// whatever V is; a V that is not a multiple of 16 (or a base off 16
// bytes) loads its stages without cp.async. Returns a CUDA error code, or
// -1 for V < 1.
int seismic_score_tiles(const uint8_t* tiles, const float* tile_scale,
                        const float* qloc, const int* pair_len,
                        const int64_t* order, const int* region,
                        const int64_t* first, const int64_t* n_groups,
                        int* next_group, int P, int V, int n_sub, float* out,
                        cudaStream_t stream) {
  if (V <= 0) return -1;
  if (P <= 0 || n_sub <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = V % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(tiles) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(qloc) % 16 == 0;
  const int rc =
      vec ? launch<true>(tiles, tile_scale, qloc, pair_len, order, region,
                         first, n_groups, next_group, V, n_sub, out, stream)
          : launch<false>(tiles, tile_scale, qloc, pair_len, order, region,
                          first, n_groups, next_group, V, n_sub, out,
                          stream);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
