// trq_group_mvm: matmul with the signed TRQ quantizer applied to every
// 128-row crossbar group's partial sums, plus the fused count of SAR
// comparator cycles (A/D operations, paper Eq. 6) and, on request, the
// auto-range fit of the step register from the call's own partial sums.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/trq_group_mvm/kernel.py::trq_group_mvm_tiles (body _kernel)
// together with the auto-range pre-fit its callers ran before it
//   repro/pim/crossbar.py::auto_range_fit (a second full read of the weights).
// For each group g:  psum = a[:, g] . w[g, :]      (full f32)
//                    s    = psum / grid
//                    y   += TRQ_signed(s) * grid
//                    ops += nu + (n_r1 if |s| in R1 else n_r2)   (twin)
//                           n_r2                                  (uniform)
// With auto-range, delta_r1 is first scaled so that the coarse range
// 2^(n_r2+m) delta_r1 covers max |psum| / grid over the whole call.
//
// Bound on an H100: the serving path calls it at M = 4 (decode) and 16
// (continued prefill) with bf16 weights: it must read the weights once
// (2 K N bytes) for 2 M K N FLOP, far below the f32 ridge (20 FLOP/byte),
// so it is bound by the bytes: 0.0151 ms at 3.35 TB/s for decode w_gate
// (4 x 3072 x 8192).  At M = 64 (prefill) the 2 M K N f32 multiply-adds
// outside the tensor cores (67 TFLOP/s) bound it: 0.0481 ms for w_down
// (64 x 8192 x 3072).
//
// Design.  A memset of the op counter and the maximum cells, then two
// kernels on the caller's stream, all issued by trq_group_mvm_launch.
// Pass 1 writes the per-group f32 partial sums to an (M, G, N) scratch
// buffer and, with auto-range, raises one of 32 device cells to its max
// |psum| (atomicMax on the bits of a non-negative float, order-
// independent).  It has two bodies; both combine partial sums in a fixed
// order (no float atomics, so results are deterministic):
//   trq_group_mvm_psums_tma (bf16 weights, M <= 16, 16-byte aligned rows:
//     decode and continued prefill).  One persistent block per SM walks the
//     (128-column tile, 128-row group) items.  A producer warp keeps 3
//     stages in flight, each a 2-D TMA copy of the 32 KB weight tile plus
//     the group's a slice into shared memory on an mbarrier, so loads stay
//     in flight while the 8 consumer warps compute and reduce.  TMA fills
//     reads past K, N or M with zeros.  A consumer warp releases a stage
//     after its last read of it, each lane behind a proxy fence: the
//     refill is an async-proxy write into the same shared memory.
//   trq_group_mvm_psums (everything else: f32 weights, M > 16, unaligned
//     rows).  One block per (m-tile of up to 16 rows, 128-column tile,
//     128-row group).  Each of the 128 threads issues its 16 loads of 16
//     bytes before it stages a in shared memory.  The m-tile is the fastest
//     grid index, so the blocks that share a weight tile run together.
//   In both, a thread owns 8 adjacent columns; weights are widened to f32
//   in registers (exact for bf16) and accumulated in f32 FMA, rows in
//   order, in chains of 8 rows (16 per group); two adjacent chains are
//   added (the TMA body's warp shuffle, the plain-load body's thread holds
//   both), then the 8 pairs in order in shared memory.  So both bodies sum
//   a partial sum in one order, whatever M is: a row's partial sums do not
//   depend on the rows it is launched with, and a split launch (below)
//   fits the same register.
//   pass 2 (trq_group_mvm_quantize): one block per (row of y, 32-column
//     strip).  It takes the maximum of the 32 cells and derives the
//     registers on the device (no host sync); its 8 warps quantize the
//     strip's G partial sums in parallel (lane = column) into shared
//     memory, warp 0 adds them to y in group order (as the plain version
//     does), and the comparator cycles, reduced per block, go into one
//     int64 counter.
// The scratch buffer holds 4 M G N bytes (M K N / 32), written once and
// read once: 3 MB at decode w_gate (12 % of the weight bytes), 1.6 GB for
// the w_gate of a 2,048-token prefill.  No tensor cores and no TF32 (TF32
// would change which quantizer bin a partial sum falls in): wgmma with
// 3xTF32 for prefill is later work.
//
// Split launch: trq_group_mvm_psums_launch runs the memset and pass 1 and
// leaves the 32 maximum cells in stats; trq_group_mvm_quantize_launch runs
// pass 2 on given cells.  Between them, ranks that each hold a block of
// the rows take the cells' maximum over the ranks (the cells are the bits
// of non-negative floats, so an int32 MAX is the float maximum): pass 2
// then fits the register one call on all the rows would fit.
//
// Ragged edges: loads beyond M, K, N read 0 (zero K rows add exact zeros to
// a partial sum, as the reference's zero padding does); the scratch, the
// maximum, the stores and the op count cover only m < M, n < N, so padded
// rows and columns add no ops and no maximum.  Op totals are int64 (the
// reference sums per-element ops in f32, exact only below 2^24).
#include <cuda.h>  // CUtensorMap types only: no libcuda link
#include <cuda_runtime.h>
#include <stdint.h>

#include "trq.cuh"

namespace {

constexpr int kXbar = 128;     // crossbar rows per group (one ADC conversion)
constexpr int kCols = 128;     // output columns per pass-1 block
constexpr int kRows = 16;      // rows of the group per pass-1 thread
constexpr int kSlice = 8;      // rows of one chain (the TMA body's slice)
constexpr int kThreads = 128;  // 4 warps: 16 column threads x 8 row pairs
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = kThreads / 16;  // 16-row pairs of slices a group
constexpr int kVec = 8;        // adjacent columns per thread (16 B of bf16)
constexpr int kMChunk = 4;     // m rows reduced through shared memory at once
constexpr int kMaxCells = 32;  // auto-range maximum cells (one per lane)
constexpr int kStats = 1 + kMaxCells / 2;  // int64: op total, max cells

// 8 adjacent weights of one row, as loaded (Raw) and widened to f32.
template <bool BF16>
struct Weights;

template <>
struct Weights<true> {
  using T = uint16_t;          // bf16 bits
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* w, size_t off,
                                             int valid, bool vec) {
    if (vec && valid == kVec)
      return __ldg(reinterpret_cast<const uint4*>(w + off));
    uint32_t h[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      h[j] = j < valid ? (uint32_t)__ldg(w + off + j) : 0u;
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                      h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  }
  // bf16 -> f32 is exact: the bf16 bits are the f32's upper half
  static __device__ __forceinline__ void widen(const Raw& r, float f[kVec]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

template <>
struct Weights<false> {
  using T = float;
  struct Raw {
    float4 lo, hi;
  };
  static __device__ __forceinline__ Raw load(const T* w, size_t off,
                                             int valid, bool vec) {
    Raw r;
    if (vec && valid == kVec) {
      r.lo = __ldg(reinterpret_cast<const float4*>(w + off));
      r.hi = __ldg(reinterpret_cast<const float4*>(w + off + 4));
      return r;
    }
    float f[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) f[j] = j < valid ? __ldg(w + off + j) : 0.f;
    r.lo = make_float4(f[0], f[1], f[2], f[3]);
    r.hi = make_float4(f[4], f[5], f[6], f[7]);
    return r;
  }
  static __device__ __forceinline__ void widen(const Raw& r, float f[kVec]) {
    f[0] = r.lo.x; f[1] = r.lo.y; f[2] = r.lo.z; f[3] = r.lo.w;
    f[4] = r.hi.x; f[5] = r.hi.y; f[6] = r.hi.z; f[7] = r.hi.w;
  }
};

// Pass 1 off the TMA path: the per-group f32 partial sums of one (MT-row,
// 128-column) tile of one group into part (M, G, N); with vmax, the
// block's max |psum| into one of the kMaxCells cells.  A thread's 16 rows
// are two of the TMA body's 8-row slices, summed as two chains and added
// as its shuffle adds them; the 8 row pairs then go in order, as its 8
// warps do.  So a partial sum is the TMA body's, bit for bit.
template <bool BF16, int MT>
__global__ void __launch_bounds__(kThreads)
trq_group_mvm_psums(const float* __restrict__ a, const void* __restrict__ w_raw,
                float* __restrict__ part, unsigned int* __restrict__ vmax,
                int M, int K, int N, int G, int vec) {
  using W = Weights<BF16>;
  const typename W::T* w = static_cast<const typename W::T*>(w_raw);
  __shared__ __align__(16) float As[kXbar][MT];       // the group's a, k-major
  __shared__ __align__(16) float red[kPairs][kMChunk][kCols];
  __shared__ float wmax[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * MT;
  const int n0 = blockIdx.y * kCols;
  const int g = blockIdx.z;
  const int k0 = g * kXbar;
  const int c = lane & 15;                    // columns n0 + 8c .. 8c + 7
  const int s = warp * 2 + (lane >> 4);       // rows k0 + 16s .. 16s + 15
  const int n = n0 + kVec * c;
  const int valid_n = max(0, min(N - n, kVec));

  // this thread's weight loads go out first, all independent
  typename W::Raw raw[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int k = k0 + kRows * s + i;
    raw[i] = W::load(w, (size_t)k * N + n, k < K ? valid_n : 0, vec != 0);
  }

  for (int idx = tid; idx < MT * kXbar; idx += kThreads) {
    const int mm = idx / kXbar, kk = idx % kXbar;
    const int gm = m0 + mm, gk = k0 + kk;
    As[kk][mm] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : 0.0f;
  }
  __syncthreads();

  float lmax = 0.0f;
#pragma unroll
  for (int mc = 0; mc < MT; mc += kMChunk) {
    // the two 8-row chains of kMChunk rows of a, rows in order
    float ps[2][kMChunk][kVec];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < kMChunk; ++q)
#pragma unroll
        for (int j = 0; j < kVec; ++j) ps[h][q][j] = 0.0f;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int h = i / kSlice;
      float wf[kVec];
      W::widen(raw[i], wf);
      const float4 t =
          *reinterpret_cast<const float4*>(&As[kRows * s + i][mc]);
      const float av[kMChunk] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int q = 0; q < kMChunk; ++q)
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          ps[h][q][j] = fmaf(av[q], wf[j], ps[h][q][j]);
    }
    // the pair, as the TMA body's shuffle adds its two slices
#pragma unroll
    for (int q = 0; q < kMChunk; ++q) {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        ps[0][q][j] = __fadd_rn(ps[0][q][j], ps[1][q][j]);
      float4* dst = reinterpret_cast<float4*>(&red[s][q][kVec * c]);
      dst[0] = make_float4(ps[0][q][0], ps[0][q][1], ps[0][q][2],
                           ps[0][q][3]);
      dst[1] = make_float4(ps[0][q][4], ps[0][q][5], ps[0][q][6],
                           ps[0][q][7]);
    }
    __syncthreads();
    // then the 8 pairs in order, as the TMA body's 8 warps
    for (int idx = tid; idx < kMChunk * kCols; idx += kThreads) {
      const int q = idx / kCols, col = idx % kCols;
      float r = red[0][q][col];
#pragma unroll
      for (int v = 1; v < kPairs; ++v) r = __fadd_rn(r, red[v][q][col]);
      const int gm = m0 + mc + q, gn = n0 + col;
      if (gm < M && gn < N) {
        part[((size_t)gm * G + g) * N + gn] = r;
        lmax = fmaxf(lmax, fabsf(r));
      }
    }
    __syncthreads();
  }

  if (vmax != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    if (lane == 0) wmax[warp] = lmax;
    __syncthreads();
    if (tid == 0) {
      float b = wmax[0];
#pragma unroll
      for (int v = 1; v < kWarps; ++v) b = fmaxf(b, wmax[v]);
      // non-negative floats order like their bit patterns; the blocks
      // spread over kMaxCells cells, so no one address takes every atomic
      if (b > 0.0f) {
        const int cell = (blockIdx.z * gridDim.y + blockIdx.y) % kMaxCells;
        atomicMax(vmax + cell, __float_as_uint(b));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 1 at decode shapes, fed by the Tensor Memory Accelerator (see the
// note at the top).  Consumer thread layout: 16 column threads (8 adjacent
// columns each) x 16 row slices (8 rows each), 4 rows of a at a time.
// ---------------------------------------------------------------------------
constexpr int kTmaWarps = 8;                     // consumer warps
constexpr int kTmaThreads = 32 * (kTmaWarps + 1);  // + one producer warp
constexpr int kTileBytes = kXbar * kCols * 2;    // one bf16 weight tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}
// Orders this thread's generic-proxy accesses to shared memory before
// later async-proxy ones (the producer's next tensor copy into the stage).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)) : "memory");
}

template <int MT>
struct TmaLayout {
  static constexpr int kStages = 3;  // deeper rings measured no faster
  static constexpr int kABytes = MT * kXbar * 4;
  static constexpr int kW = 0;
  static constexpr int kA = kW + kStages * kTileBytes;
  static constexpr int kRed = kA + kStages * kABytes;
  static constexpr int kBar = kRed + kTmaWarps * 4 * kCols * 4;
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 128;  // + alignment
};

template <int MT>
__global__ void __launch_bounds__(kTmaThreads, 1)
trq_group_mvm_psums_tma(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap amap,
                        float* __restrict__ part,
                        unsigned int* __restrict__ vmax, int M, int N, int G,
                        int tiles) {
  using L = TmaLayout<MT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* red = reinterpret_cast<float*>(smem + L::kRed);  // [warp][4][kCols]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* empty = full + L::kStages;
  __shared__ float wmax[kTmaWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int items = tiles * G;
  if (tid == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kTmaWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kTmaWarps) {  // the producer
    if (lane == 0) {
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int st = it % L::kStages, round = it / L::kStages;
        if (round > 0) mbar_wait(empty + st, (round - 1) & 1);
        const int tile = item % tiles, g = item / tiles;
        mbar_expect_tx(full + st, kTileBytes + L::kABytes);
        tma_load_2d(smem + L::kW + st * kTileBytes, &wmap, full + st,
                    tile * kCols, g * kXbar);
        tma_load_2d(smem + L::kA + st * L::kABytes, &amap, full + st,
                    g * kXbar, 0);
      }
    }
    return;
  }

  const int c = lane & 15;                  // columns 8c .. 8c + 7 of a tile
  const int s = warp * 2 + (lane >> 4);     // rows 8s .. 8s + 7 of a group
  const int chunks = (M + 3) / 4;
  float lmax = 0.0f;
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int st = it % L::kStages, round = it / L::kStages;
    const int tile = item % tiles, g = item / tiles;
    mbar_wait(full + st, round & 1);
    const unsigned char* wt = smem + L::kW + st * kTileBytes;
    const float* at =
        reinterpret_cast<const float*>(smem + L::kA + st * L::kABytes);
    uint4 raw[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      raw[i] = *reinterpret_cast<const uint4*>(wt + (8 * s + i) * (2 * kCols) +
                                               16 * c);
#pragma unroll
    for (int mc = 0; mc < MT; mc += 4) {
      if (mc / 4 >= chunks) break;
      float ps[4][kVec];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < kVec; ++j) ps[q][j] = 0.0f;
      float av[4][8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 lo =
            *reinterpret_cast<const float4*>(at + (mc + q) * kXbar + 8 * s);
        const float4 hi =
            *reinterpret_cast<const float4*>(at + (mc + q) * kXbar + 8 * s + 4);
        av[q][0] = lo.x; av[q][1] = lo.y; av[q][2] = lo.z; av[q][3] = lo.w;
        av[q][4] = hi.x; av[q][5] = hi.y; av[q][6] = hi.z; av[q][7] = hi.w;
      }
      // rows in order, as the other pass-1 body accumulates them
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float wf[kVec];
        Weights<true>::widen(raw[i], wf);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            ps[q][j] = fmaf(av[q][i], wf[j], ps[q][j]);
      }
      if (mc + 4 >= MT || mc / 4 + 1 >= chunks) {
        // the stage's last read: hand it back to the producer.  Its refill
        // is an async-proxy write, so a proxy fence orders this lane's
        // generic reads of the weight and activation tiles before it
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + st);
      }
      // the warp's two row slices, then the 8 warps in order
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < kVec; ++j)
          ps[q][j] = __fadd_rn(ps[q][j],
                               __shfl_xor_sync(0xffffffffu, ps[q][j], 16));
      if (lane < 16) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4* dst = reinterpret_cast<float4*>(
              red + (warp * 4 + q) * kCols + kVec * c);
          dst[0] = make_float4(ps[q][0], ps[q][1], ps[q][2], ps[q][3]);
          dst[1] = make_float4(ps[q][4], ps[q][5], ps[q][6], ps[q][7]);
        }
      }
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kTmaWarps) : "memory");
#pragma unroll
      for (int r = 0; r < 4 * kCols / (32 * kTmaWarps); ++r) {
        const int idx = tid + r * 32 * kTmaWarps;
        const int q = idx / kCols, col = idx % kCols;
        float v = red[q * kCols + col];
#pragma unroll
        for (int w = 1; w < kTmaWarps; ++w)
          v = __fadd_rn(v, red[(w * 4 + q) * kCols + col]);
        const int gm = mc + q, gn = tile * kCols + col;
        if (gm < M && gn < N) {
          part[((size_t)gm * G + g) * N + gn] = v;
          lmax = fmaxf(lmax, fabsf(v));
        }
      }
      asm volatile("bar.sync 1, %0;" ::"n"(32 * kTmaWarps) : "memory");
    }
  }

  if (vmax != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    if (lane == 0) wmax[warp] = lmax;
    asm volatile("bar.sync 1, %0;" ::"n"(32 * kTmaWarps) : "memory");
    if (tid == 0) {
      float b = wmax[0];
#pragma unroll
      for (int v = 1; v < kTmaWarps; ++v) b = fmaxf(b, wmax[v]);
      if (b > 0.0f) atomicMax(vmax + blockIdx.x % kMaxCells, __float_as_uint(b));
    }
  }
}

// The auto-range register, in the IEEE steps of
// repro_torch/pim/crossbar.py::auto_range_fit_grouped (and of the
// reference): span = vmax / grid; / 2^(n_r2+m) (exact); max(., 1e-6);
// delta_r1 * that.  Equal maxima give equal registers.
__device__ __forceinline__ float auto_range_delta(float delta_r1, float vmax,
                                                  float grid, int reach) {
  const float span = __fdiv_rn(vmax, grid);
  const float scale = fmaxf(__fdiv_rn(span, ldexpf(1.0f, reach)), 1e-6f);
  return __fmul_rn(delta_r1, scale);
}

// Pass 2: one block per (row m, 32-column strip), row-major.  The 8 warps
// quantize the strip's G partial sums in parallel (lane = column, warp w
// takes groups w, w + 8, ...) into shared memory, kQChunk groups at a time;
// warp 0 then adds them to y in group order, as the plain version does.
// Comparator cycles are reduced per block into one int64 counter.
constexpr int kQCols = 32;
constexpr int kQChunk = 64;
constexpr int kQWarps = 8;

__global__ void __launch_bounds__(32 * kQWarps)
trq_group_mvm_quantize(const float* __restrict__ part,
                       const float* __restrict__ scalars,
                       const unsigned int* __restrict__ vmax,
                       float* __restrict__ y,
                       unsigned long long* __restrict__ ops_total, int M,
                       int N, int G, int n_r1, int n_r2, int m, int nu,
                       int uniform) {
  __shared__ float qs[kQChunk][kQCols];
  __shared__ unsigned int block_ops[kQWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float grid = scalars[2];
  float delta_r1 = scalars[0];
  if (vmax != nullptr) {
    float v = __uint_as_float(vmax[lane]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    delta_r1 = auto_range_delta(delta_r1, v, grid, n_r2 + m);
  }
  const TrqRegs regs =
      trq_regs(delta_r1, scalars[1], n_r1, n_r2, m, nu, uniform != 0);

  const int strips = (N + kQCols - 1) / kQCols;
  const int row = blockIdx.x / strips;
  const int col = (blockIdx.x % strips) * kQCols + lane;
  const bool valid = col < N;
  const float* p = part + (size_t)row * G * N + col;
  unsigned int my_ops = 0;
  float acc = 0.0f;
  for (int g0 = 0; g0 < G; g0 += kQChunk) {
    const int gn = min(kQChunk, G - g0);
#pragma unroll 4
    for (int i = warp; i < gn; i += kQWarps) {
      int o = 0;
      float q = 0.0f;
      if (valid) {
        q = __fmul_rn(trq_signed(__fdiv_rn(p[(size_t)(g0 + i) * N], grid),
                                 regs, &o), grid);
      }
      qs[i][lane] = q;
      my_ops += (unsigned int)o;
    }
    __syncthreads();
    if (warp == 0) {
      for (int i = 0; i < gn; ++i) acc = __fadd_rn(acc, qs[i][lane]);
    }
    __syncthreads();
  }
  if (warp == 0 && valid) y[(size_t)row * N + col] = acc;

  // op total: warp reduction, block reduction, one 64-bit atomic per block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_ops += __shfl_down_sync(0xffffffffu, my_ops, off);
  if (lane == 0) block_ops[warp] = my_ops;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
#pragma unroll
    for (int v = 0; v < kQWarps; ++v) t += block_ops[v];
    if (t) atomicAdd(ops_total, t);
  }
}

template <bool BF16, int MT>
void launch_pass1(const float* a, const void* w, float* part,
                  unsigned int* vmax, int M, int K, int N, int G, int vec,
                  cudaStream_t s) {
  const dim3 grid((M + MT - 1) / MT, (N + kCols - 1) / kCols, G);
  trq_group_mvm_psums<BF16, MT><<<grid, kThreads, 0, s>>>(a, w, part, vmax, M,
                                                      K, N, G, vec);
}

template <bool BF16>
void pass1(const float* a, const void* w, float* part, unsigned int* vmax,
           int M, int K, int N, int G, int vec, cudaStream_t s) {
  if (M <= 4)
    launch_pass1<BF16, 4>(a, w, part, vmax, M, K, N, G, vec, s);
  else if (M <= 8)
    launch_pass1<BF16, 8>(a, w, part, vmax, M, K, N, G, vec, s);
  else
    launch_pass1<BF16, 16>(a, w, part, vmax, M, K, N, G, vec, s);
}

// cuTensorMapEncodeTiled, reached through the runtime (no libcuda link)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D row-major map of (rows, cols) elements with a (box_rows, box_cols)
// box; reads past the edges return zeros.
bool tensor_map(CUtensorMap* map, const void* base, CUtensorMapDataType dt,
                int elem, int rows, int cols, int box_rows, int box_cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MT>
cudaError_t launch_pass1_tma(const float* a, const void* w, float* part,
                             unsigned int* vmax, int M, int K, int N, int G,
                             cudaStream_t s) {
  // set only once the attribute is: a second host thread's first call
  // (ranks that share a process) sets it again rather than launch early
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    cudaError_t err = cudaFuncSetAttribute(
        trq_group_mvm_psums_tma<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TmaLayout<MT>::kBytes);
    if (err != cudaSuccess) return err;
    sms = count;
  }
  CUtensorMap wmap, amap;
  if (!tensor_map(&wmap, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, kXbar,
                  kCols) ||
      !tensor_map(&amap, a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, K, MT,
                  kXbar))
    return cudaErrorInvalidValue;
  const int tiles = (N + kCols - 1) / kCols;
  const int blocks = min(tiles * G, sms);
  trq_group_mvm_psums_tma<MT><<<blocks, kTmaThreads, TmaLayout<MT>::kBytes,
                                s>>>(wmap, amap, part, vmax, M, N, G, tiles);
  return cudaGetLastError();
}

cudaError_t pass1_tma(const float* a, const void* w, float* part,
                      unsigned int* vmax, int M, int K, int N, int G,
                      cudaStream_t s) {
  if (M <= 4) return launch_pass1_tma<4>(a, w, part, vmax, M, K, N, G, s);
  if (M <= 8) return launch_pass1_tma<8>(a, w, part, vmax, M, K, N, G, s);
  return launch_pass1_tma<16>(a, w, part, vmax, M, K, N, G, s);
}

// Pass 1 on the TMA body where it applies, else the plain-load body.
cudaError_t run_pass1(const float* a, const void* w, int w_bf16, float* part,
                      unsigned int* vmax, int M, int K, int N, int G,
                      cudaStream_t s) {
  // 16-byte weight loads and TMA maps need 16-byte aligned rows
  const bool aligned = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const bool a_aligned = (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  if (w_bf16 && M <= 16 && aligned && a_aligned && N % 8 == 0 && K % 4 == 0)
    return pass1_tma(a, w, part, vmax, M, K, N, G, s);
  if (w_bf16)
    pass1<true>(a, w, part, vmax, M, K, N, G, aligned && N % 8 == 0, s);
  else
    pass1<false>(a, w, part, vmax, M, K, N, G, aligned && N % 4 == 0, s);
  return cudaGetLastError();
}

cudaError_t run_pass2(const float* part, const float* scalars,
                      const unsigned int* vmax, float* y,
                      unsigned long long* ops, int M, int N, int G, int n_r1,
                      int n_r2, int m, int nu, int uniform, cudaStream_t s) {
  const unsigned int blocks = (unsigned int)M * ((N + kQCols - 1) / kQCols);
  trq_group_mvm_quantize<<<blocks, 32 * kQWarps, 0, s>>>(
      part, scalars, vmax, y, ops, M, N, G, n_r1, n_r2, m, nu, uniform);
  return cudaGetLastError();
}

}  // namespace

// a: (M, K) f32 row-major; w: (K, N) row-major, bf16 (w_bf16 = 1) or f32;
// scalars: [delta_r1, bias, grid] f32 on the device; part: (M, G, N) f32
// scratch, G = ceil(K / 128); y: (M, N) f32 out; stats: kStats int64 this
// call zeroes on the stream, [0] the op total of the valid region, then the
// kMaxCells auto-range maximum cells (u32 float bits); auto_range: derive
// delta_r1 from the call's own partial sums.  M, K and N are at least 1.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int trq_group_mvm_launch(const float* a, const void* w,
                                    int w_bf16, const float* scalars,
                                    float* part, float* y,
                                    unsigned long long* stats, int M, int K,
                                    int N, int n_r1, int n_r2, int m, int nu,
                                    int uniform, int auto_range,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = (K + kXbar - 1) / kXbar;
  unsigned int* vmax =
      auto_range ? reinterpret_cast<unsigned int*>(stats + 1) : nullptr;
  cudaError_t err = cudaMemsetAsync(stats, 0, kStats * sizeof(*stats), s);
  if (err == cudaSuccess) err = run_pass1(a, w, w_bf16, part, vmax, M, K, N,
                                          G, s);
  if (err == cudaSuccess)
    err = run_pass2(part, scalars, vmax, y, stats, M, N, G, n_r1, n_r2, m, nu,
                    uniform, s);
  return static_cast<int>(err);
}

// The split launch's first half: zero stats, then pass 1 with the maximum
// cells always on.  Operands as trq_group_mvm_launch's.
extern "C" int trq_group_mvm_psums_launch(const float* a, const void* w,
                                          int w_bf16, float* part,
                                          unsigned long long* stats, int M,
                                          int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = (K + kXbar - 1) / kXbar;
  cudaError_t err = cudaMemsetAsync(stats, 0, kStats * sizeof(*stats), s);
  if (err == cudaSuccess)
    err = run_pass1(a, w, w_bf16, part,
                    reinterpret_cast<unsigned int*>(stats + 1), M, K, N, G, s);
  return static_cast<int>(err);
}

// The split launch's second half: pass 2 on part with delta_r1 fitted to
// the maximum of the cells in stats (as reduced over the ranks), adding
// the op total of the valid region to stats[0].
extern "C" int trq_group_mvm_quantize_launch(const float* part,
                                             const float* scalars, float* y,
                                             unsigned long long* stats, int M,
                                             int K, int N, int n_r1, int n_r2,
                                             int m, int nu, int uniform,
                                             void* stream) {
  const int G = (K + kXbar - 1) / kXbar;
  return static_cast<int>(run_pass2(
      part, scalars, reinterpret_cast<const unsigned int*>(stats + 1), y,
      stats, M, N, G, n_r1, n_r2, m, nu, uniform,
      static_cast<cudaStream_t>(stream)));
}
