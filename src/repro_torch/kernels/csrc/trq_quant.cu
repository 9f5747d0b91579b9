// trq_quant: elementwise TRQ fake-quant and SAR comparator-cycle count, and
// the scoring entry Algorithm 1 calibrates with.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/trq_quant/kernel.py::trq_quant_tiles (body _kernel)
// For every element x:  q   = T(x)            (unsigned)
//                       q   = sign(x)*T(|x|)  (signed)
//                       ops = nu + (n_r1 if in R1 else n_r2), or n_r2 in
//                             uniform mode
//
// Elementwise entry (trq_quant_launch).  Bound on an H100: the kernel reads
// 4 bytes (f32; 2 for f16) and writes 8 bytes per element for a few dozen
// ALU operations, far below the card's ridge point — it is bound by HBM
// bytes.  The design therefore does no tiling and no padding: one thread per
// element of the flattened tensor, grid-stride, neighbouring threads on
// neighbouring addresses so every load and store coalesces; the registers
// [delta_r1, bias] are read once per thread from a device pointer.
//
// Scoring entry (trq_score_launch).  Algorithm 1 reduces each candidate's
// q and ops to two numbers, the sum of (q - y)^2 and the sum of ops over a
// layer's samples, and scores every candidate of the layer on the same
// samples (about 154 for a `normal` layer, 450 for an `other` one, at
// n = 65,536).  The TPU kernel served that as one elementwise call per
// candidate, 8 bytes written per element only to be summed again.  Here
// the samples (256 KB) are read from HBM once and stay in L2, and each
// block holds a slice of 2,048 of them in registers (8 a thread) while it
// walks a group of 8 candidates from shared memory: the grid is slices x
// candidate groups (32 x 20 blocks at n = 65,536 and C = 154, about five
// on each SM), and nothing but one partial per (candidate, slice) goes back
// to memory.  Bound: instruction rate, not bytes — C * n quantizer
// evaluations, each the instructions of its path in the SASS (the correctly
// rounded division stays: the floor boundaries depend on its last ulp),
// over the card's 4 x 32 lanes a cycle on each of the 132 SMs;
// chip_smoke.py counts them from `cuobjdump -sass` of this build.
// Arithmetic: q and the op count are trq.cuh's, each error is
// __fsub_rn(q, y) squared with __fmul_rn in f32 (the reference's
// jnp.square(q - x), no FMA), widened to f64 only to be added; ops are
// summed in integers.  The sums are reduced in a fixed order — a warp
// butterfly, the block's 8 warps in order, then a second pass over the
// slices, one warp a candidate, in order — with no atomics, so a call
// gives the same bits every time.  On integral steps over integer samples
// every squared error is an integer below 2^15 and the f64 sums are exact
// in any order (PyTorch's f64 sum gives the same bits).
//
// The quantizer is trq.cuh's, the same device function K1 and K3 call, so
// the three kernels agree bit for bit.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trq.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float widen(T v);
template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }
template <>
__device__ __forceinline__ float widen<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__global__ void __launch_bounds__(256)
trq_quant_kernel(const T* __restrict__ x, const float* __restrict__ scalars,
                 float* __restrict__ q, int32_t* __restrict__ ops, int64_t n,
                 int n_r1, int n_r2, int m, int nu, int uniform,
                 int is_signed) {
  const TrqRegs regs =
      trq_regs(scalars[0], scalars[1], n_r1, n_r2, m, nu, uniform != 0);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = widen<T>(x[i]);
    int o;
    q[i] = is_signed ? trq_signed(v, regs, &o) : trq_unsigned(v, regs, &o);
    ops[i] = o;
  }
}

}  // namespace

// x: n contiguous elements, f32 (is_half = 0) or f16 (is_half = 1);
// scalars: [delta_r1, bias] f32 on the device; q: n f32 out; ops: n int32
// out.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int trq_quant_launch(const void* x, int is_half,
                                const float* scalars, float* q, int32_t* ops,
                                long long n, int n_r1, int n_r2, int m,
                                int nu, int uniform, int is_signed,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  // enough blocks to fill every SM several times over; the grid-stride loop
  // covers the rest
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132LL * 16 ? want : 132LL * 16);
  if (is_half) {
    trq_quant_kernel<__half><<<blocks, kThreads, 0, s>>>(
        static_cast<const __half*>(x), scalars, q, ops, n, n_r1, n_r2, m, nu,
        uniform, is_signed);
  } else {
    trq_quant_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), scalars, q, ops, n, n_r1, n_r2, m, nu,
        uniform, is_signed);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// scoring entry
// ---------------------------------------------------------------------------

namespace {

constexpr int kScoreThreads = 256;
constexpr int kScorePer = 8;                     // samples a thread holds
constexpr int kScoreSlice = kScoreThreads * kScorePer;  // samples a block
constexpr int kScoreGroup = 8;                   // candidates a block scores
constexpr int kScoreWarps = kScoreThreads / 32;
constexpr int kIregs = 6;                        // n_r1 n_r2 m nu mode signed

// Pass 1: block (x, y) scores candidates [8 y, 8 y + 8) on samples
// [2048 x, 2048 x + 2048) and writes one partial of each sum per candidate:
// part_*[c * gridDim.x + x].
template <typename T>
__global__ void __launch_bounds__(kScoreThreads)
trq_score_partials(const T* __restrict__ y, int64_t n,
                   const float* __restrict__ fregs,
                   const int32_t* __restrict__ iregs, int n_cand,
                   double* __restrict__ part_sq,
                   long long* __restrict__ part_ops) {
  __shared__ TrqRegs regs[kScoreGroup];
  __shared__ int is_signed[kScoreGroup];
  __shared__ double warp_sq[kScoreGroup][kScoreWarps];
  __shared__ int warp_ops[kScoreGroup][kScoreWarps];
  const int c0 = blockIdx.y * kScoreGroup;
  const int nc = min(kScoreGroup, n_cand - c0);
  if (threadIdx.x < nc) {
    const int c = c0 + threadIdx.x;
    const int32_t* ir = iregs + (int64_t)c * kIregs;
    regs[threadIdx.x] = trq_regs(fregs[2 * c], fregs[2 * c + 1], ir[0],
                                 ir[1], ir[2], ir[3], ir[4] != 0);
    is_signed[threadIdx.x] = ir[5];
  }
  // this thread's samples, coalesced, into registers for every candidate
  float v[kScorePer];
  bool ok[kScorePer];
  const int64_t base = (int64_t)blockIdx.x * kScoreSlice + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kScorePer; ++j) {
    const int64_t i = base + (int64_t)j * kScoreThreads;
    ok[j] = i < n;
    v[j] = ok[j] ? widen<T>(y[i]) : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = 0; c < nc; ++c) {
    const TrqRegs r = regs[c];
    const bool sgn = is_signed[c] != 0;
    double sq = 0.0;
    int ops = 0;
#pragma unroll
    for (int j = 0; j < kScorePer; ++j) {
      if (ok[j]) {
        int o;
        const float q = sgn ? trq_signed(v[j], r, &o)
                            : trq_unsigned(v[j], r, &o);
        const float d = __fsub_rn(q, v[j]);
        sq = __dadd_rn(sq, (double)__fmul_rn(d, d));
        ops += o;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sq = __dadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
      ops += __shfl_xor_sync(0xffffffffu, ops, off);
    }
    if (lane == 0) {
      warp_sq[c][warp] = sq;
      warp_ops[c][warp] = ops;
    }
  }
  __syncthreads();
  if (threadIdx.x < nc) {
    double sq = 0.0;
    long long ops = 0;
#pragma unroll
    for (int w = 0; w < kScoreWarps; ++w) {
      sq = __dadd_rn(sq, warp_sq[threadIdx.x][w]);
      ops += warp_ops[threadIdx.x][w];
    }
    const int64_t at = (int64_t)(c0 + threadIdx.x) * gridDim.x + blockIdx.x;
    part_sq[at] = sq;
    part_ops[at] = ops;
  }
}

// Pass 2: one warp a candidate sums its slices' partials, lane l taking
// slices l, l + 32, ... in order, then the butterfly.
__global__ void __launch_bounds__(kScoreThreads)
trq_score_total(const double* __restrict__ part_sq,
                const long long* __restrict__ part_ops, int n_cand,
                int slices, double* __restrict__ sum_sq,
                long long* __restrict__ sum_ops) {
  const int c = blockIdx.x * kScoreWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= n_cand) return;  // the whole warp leaves together
  double sq = 0.0;
  long long ops = 0;
  for (int s = lane; s < slices; s += 32) {
    sq = __dadd_rn(sq, part_sq[(int64_t)c * slices + s]);
    ops += part_ops[(int64_t)c * slices + s];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sq = __dadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
    ops += __shfl_xor_sync(0xffffffffu, ops, off);
  }
  if (lane == 0) {
    sum_sq[c] = sq;
    sum_ops[c] = ops;
  }
}

}  // namespace

// y: n contiguous samples, f32 (is_half = 0) or f16 (is_half = 1);
// fregs: n_cand rows [delta_r1, bias] f32; iregs: n_cand rows [n_r1, n_r2,
// m, nu, mode (1 = uniform), signed] int32; part_sq / part_ops: scratch of
// n_cand * slices each, slices = ceil(n / 2048); sum_sq (f64) / sum_ops
// (int64): n_cand out, the sums of (q - y)^2 and of ops per candidate.  All
// on the device.  Returns cudaGetLastError() after both launches (0 on
// success), or cudaErrorInvalidValue for a scratch of the wrong size.
extern "C" int trq_score_launch(const void* y, int is_half, long long n,
                                const float* fregs, const int32_t* iregs,
                                int n_cand, int slices, double* part_sq,
                                long long* part_ops, double* sum_sq,
                                long long* sum_ops, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (n + kScoreSlice - 1) / kScoreSlice;
  const long long groups = (n_cand + kScoreGroup - 1) / kScoreGroup;
  if (n < 1 || n_cand < 1 || slices != want || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((unsigned)slices, (unsigned)groups);
  if (is_half) {
    trq_score_partials<__half><<<grid, kScoreThreads, 0, s>>>(
        static_cast<const __half*>(y), n, fregs, iregs, n_cand, part_sq,
        part_ops);
  } else {
    trq_score_partials<float><<<grid, kScoreThreads, 0, s>>>(
        static_cast<const float*>(y), n, fregs, iregs, n_cand, part_sq,
        part_ops);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  trq_score_total<<<(n_cand + kScoreWarps - 1) / kScoreWarps, kScoreThreads,
                    0, s>>>(part_sq, part_ops, n_cand, slices, sum_sq,
                            sum_ops);
  return static_cast<int>(cudaGetLastError());
}
