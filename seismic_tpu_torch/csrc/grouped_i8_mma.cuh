// One work item of the grouped int8 scorers on the int8 tensor cores,
// shared by the item-major (grouped_scorer_item.cu, K4) and the slot-major
// (grouped_scorer.cu, K2) kernel, which differ only in where they store
// the block.
//
//   s_out[m * kRows + r] = (float)(sum_v q[m, v] * u8[row0 + r, v])
//                          * tile_scale[row0 + r]
//
// The product runs as mma.sync.m16n8k32 with u8 A (16 tile rows x 32
// bytes) and s8 B (32 bytes x 8 query slots), int32 accumulators: the dot
// is exact and needs neither a recentring of the u8 codes nor a 128 *
// sum(q) correction, and the accumulators come out in the fragment layout
// (no butterfly).
//
// Layout. The block is 256 threads, 8 warps; warp w owns tile rows
// [w * RW, (w + 1) * RW), RW = kRows / 8 (16 or 32: one or two m16 tiles),
// and all kM query slots (one or two n8 tiles). A warp streams its rows in
// k-slices of 64 bytes through a private ring of kStages shared-memory
// stages, filled with 16-byte cp.async (L2 only, .cg): a stage holds its
// RW rows at a 64-byte pitch, so the 8 lanes of one 16-byte shared load
// (two rows x four 16-byte columns) cover 128 distinct bytes, all 32
// banks, with no swizzle (rows V bytes apart would put them all on one
// bank set). The group's [kM, V] queries are staged once per block in the
// same k-slice order ([V / 64][kM][64] bytes).
//
// Fragments. Lane (g = lane / 4, t = lane % 4) reads 16 bytes, at column
// t * 16 of its slice, of each of its rows g and g + 8 and of its query
// rows g (+ 8). The k order inside a slice is permuted the same way for
// A and B (PTX's logical k = 4t + j of a k32 step is byte t * 16 + 8s + j,
// logical k = 16 + 4t + j byte t * 16 + 8s + 4 + j, for step s = 0, 1), so
// one 16-byte load feeds two k32 steps and the sum is unchanged.
//
// After the last slice every warp's ring is free: s_out (kM * kRows f32)
// aliases the start of shared memory. The function ends with
// __syncthreads().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMmaThreads = 256;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kSliceBytes = 64;  // bytes of a row one pipeline stage holds
constexpr int kStages = 4;       // ring depth of each warp
constexpr int kMaxDevices = 64;

// bytes of dynamic shared memory a block needs: the warps' rings, then
// the group's queries
template <int kM, int kRows, int V>
constexpr int mma_item_smem() {
  return kMmaWarps * kStages * (kRows / kMmaWarps) * kSliceBytes + kM * V;
}

// Above 48 KB a launch needs the kernel's opt-in, once per device; `done`
// remembers the devices already opted in. Returns the error.
template <typename F>
cudaError_t opt_in_smem(F kernel, int smem, bool (&done)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
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

template <int kM, int kRows, int V>
__device__ __forceinline__ void score_item_mma(
    const uint8_t* __restrict__ tiles,     // [rows, V]
    const float* __restrict__ tile_scale,  // [rows]
    const int8_t* __restrict__ qg,         // [kM, V], the group's queries
    int64_t row0, uint8_t* smem,           // dynamic shared memory
    float* s_out) {                        // [kM * kRows], aliases smem
  constexpr int RW = kRows / kMmaWarps;  // rows of one warp
  constexpr int MT = RW / 16;            // its m16 tiles
  constexpr int NT = kM / 8;             // n8 tiles of query slots
  constexpr int NK = V / kSliceBytes;    // k-slices
  constexpr int kStageBytes = RW * kSliceBytes;
  constexpr int kCopies = kStageBytes / 16 / 32;  // cp.async a lane a stage
  static_assert(MT >= 1 && NT >= 1 && NK >= 1 && kCopies >= 1, "shape");
  static_assert(kM * kRows * 4 <= kMmaWarps * kStages * kStageBytes,
                "s_out must fit in the rings");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  uint8_t* ring = smem + warp * (kStages * kStageBytes);
  int8_t* s_q =
      reinterpret_cast<int8_t*>(smem + kMmaWarps * kStages * kStageBytes);
  const uint8_t* wrows = tiles + (row0 + warp * RW) * V;

  // stage ks % kStages <- rows' bytes [ks * 64, +64), chunk i = row i / 4,
  // 16-byte column i % 4, at i * 16
  auto load_slice = [&](int ks) {
    const unsigned st = smem_addr(ring + (ks % kStages) * kStageBytes);
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int i = lane + 32 * j;
      cp_async16(st + i * 16,
                 wrows + (i >> 2) * V + ks * kSliceBytes + (i & 3) * 16);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < NK) load_slice(s);
    cp_async_commit();
  }

  // the group's queries, k-slice major: s_q[ks][m][64]
  for (int i = threadIdx.x; i < kM * V / 16; i += kMmaThreads) {
    const int m = i / (V / 16);
    const int c = i % (V / 16);
    *reinterpret_cast<int4*>(s_q + (c >> 2) * (kM * kSliceBytes) +
                             m * kSliceBytes + (c & 3) * 16) =
        reinterpret_cast<const int4*>(qg + m * V)[c];
  }
  float scale[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int64_t r = row0 + warp * RW + mt * 16 + g;
    scale[mt][0] = tile_scale[r];
    scale[mt][1] = tile_scale[r + 8];
  }
  __syncthreads();

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0;
    }
  }

#pragma unroll 1
  for (int ks = 0; ks < NK; ++ks) {
    if (ks + kStages - 1 < NK) load_slice(ks + kStages - 1);
    cp_async_commit();             // (empty past the last slice)
    cp_async_wait<kStages - 1>();  // this lane's copies of slice ks landed
    __syncwarp();                  // ... and every lane's
    const uint8_t* st = ring + (ks % kStages) * kStageBytes;
    const int8_t* sq = s_q + ks * (kM * kSliceBytes);
    int4 b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      b[n] = *reinterpret_cast<const int4*>(sq + (n * 8 + g) * kSliceBytes +
                                            t * 16);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int4 lo = *reinterpret_cast<const int4*>(
          st + (mt * 16 + g) * kSliceBytes + t * 16);
      const int4 hi = *reinterpret_cast<const int4*>(
          st + (mt * 16 + g + 8) * kSliceBytes + t * 16);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_u8s8(acc[mt][n], lo.x, hi.x, lo.y, hi.y, b[n].x, b[n].y);
        mma_u8s8(acc[mt][n], lo.z, hi.z, lo.w, hi.w, b[n].z, b[n].w);
      }
    }
    __syncwarp();  // the next iteration refills this stage
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
        s_out[(m + (i & 1)) * kRows + r + 8 * (i >> 1)] =
            static_cast<float>(acc[mt][n][i]) * scale[mt][i >> 1];
      }
    }
  }
  __syncthreads();
}
