// trq_group_mvm: K-blocked f32 matmul with the signed TRQ quantizer applied
// to every 128-row crossbar group's partial sums, plus the fused count of
// SAR comparator cycles (A/D operations, paper Eq. 6).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/trq_group_mvm/kernel.py::trq_group_mvm_tiles (body _kernel)
// For each group g:  psum = a[:, g] . w[g, :]      (full f32)
//                    s    = psum / grid
//                    y   += TRQ_signed(s) * grid
//                    ops += nu + (n_r1 if |s| in R1 else n_r2)   (twin)
//                           n_r2                                  (uniform)
//
// Bound on an H100: at decode shapes (M = 4) the kernel must read the f32
// weight image once (4*K*N bytes) for 8*K*N FLOP — memory-bound; at prefill
// shapes (M = 64) it does 2*M*K*N FLOP of f32 FFMA for 4*K*N bytes, about
// 32 FLOP/byte, above the card's 20 FLOP/byte f32 (non-tensor-core) ridge —
// bound by f32 FFMA.  The design answers the TPU kernel's point (never
// materialise the (M, G, N) partial-sum tensor): the quantizer runs on the
// group's partial sums in registers, so the kernel moves only a, w and y.
// It is deliberately simple — one block per output tile, the TPU's
// sequential k grid axis as a loop over groups inside the block, A and W
// chunks staged in shared memory, f32 FFMA in a fixed order over the 128
// rows, no tensor cores and no TF32 (TF32 would change which quantizer bin
// a partial sum falls in).  Pipelined loads, bf16 weights widened in
// registers and wgmma/3xTF32 are later work.
//
// Ragged edges: loads beyond M, K, N read 0 (zero K rows add exact zeros
// to a partial sum, as the reference's zero padding does); stores and op
// counts beyond M, N are masked, so padded rows/columns add no ops.
// The op total is reduced per warp and added into one int64 counter (the
// reference sums per-element ops in f32, exact only below 2^24).
#include <cuda_runtime.h>
#include <stdint.h>

#include "trq.cuh"

namespace {

constexpr int kXbar = 128;   // crossbar rows per group (one ADC conversion)
constexpr int kChunk = 32;   // K rows staged in shared memory at a time

template <int TY, int TX, int RPT>
__global__ void __launch_bounds__(TY * TX)
trq_group_mvm_kernel(const float* __restrict__ a, const float* __restrict__ w,
                     const float* __restrict__ scalars, float* __restrict__ y,
                     unsigned long long* __restrict__ ops_total, int M, int K,
                     int N, int n_r1, int n_r2, int m, int nu, int uniform) {
  constexpr int BM = TY * RPT;        // output rows per block
  constexpr int BN = TX * 4;          // output columns per block
  constexpr int NT = TY * TX;         // threads per block
  __shared__ float As[BM][kChunk + 1];  // +1: conflict-free column reads
  __shared__ float Ws[kChunk][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // [delta_r1, bias, grid] live on the device: the auto-range fit writes
  // them every call, and reading them here keeps the host from syncing
  const float grid = scalars[2];
  const TrqRegs regs =
      trq_regs(scalars[0], scalars[1], n_r1, n_r2, m, nu, uniform != 0);

  float acc[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  unsigned int my_ops = 0;

  const int groups = (K + kXbar - 1) / kXbar;
  for (int g = 0; g < groups; ++g) {
    float ps[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[i][j] = 0.0f;

    for (int kc = 0; kc < kXbar; kc += kChunk) {
      const int k0 = g * kXbar + kc;
      if (k0 >= K) break;             // the rest of the group is padding
      for (int idx = tid; idx < BM * kChunk; idx += NT) {
        const int r = idx / kChunk, c = idx % kChunk;
        const int gm = m0 + r, gk = k0 + c;
        As[r][c] = (gm < M && gk < K) ? a[(size_t)gm * K + gk] : 0.0f;
      }
      for (int idx = tid; idx < kChunk * BN; idx += NT) {
        const int r = idx / BN, c = idx % BN;
        const int gk = k0 + r, gn = n0 + c;
        Ws[r][c] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) {
        float av[RPT], wv[4];
#pragma unroll
        for (int i = 0; i < RPT; ++i) av[i] = As[ty + TY * i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = Ws[k][tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ps[i][j] = fmaf(av[i], wv[j], ps[i][j]);
      }
      __syncthreads();
    }

    // group epilogue: one A/D conversion per output element, in registers
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const bool row_ok = (m0 + ty + TY * i) < M;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int o;
        const float q = trq_signed(__fdiv_rn(ps[i][j], grid), regs, &o);
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(q, grid));
        if (row_ok && (n0 + tx + TX * j) < N) my_ops += (unsigned int)o;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gm = m0 + ty + TY * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + TX * j;
      if (gm < M && gn < N) y[(size_t)gm * N + gn] = acc[i][j];
    }
  }

  // op total: warp reduction, then one 64-bit atomic per warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_ops += __shfl_down_sync(0xffffffffu, my_ops, off);
  if ((tid & 31) == 0 && my_ops)
    atomicAdd(ops_total, (unsigned long long)my_ops);
}

template <int TY, int TX, int RPT>
void launch(const float* a, const float* w, const float* scalars, float* y,
            unsigned long long* ops, int M, int K, int N, int n_r1, int n_r2,
            int m, int nu, int uniform, cudaStream_t stream) {
  constexpr int BM = TY * RPT, BN = TX * 4;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  trq_group_mvm_kernel<TY, TX, RPT><<<grid, TY * TX, 0, stream>>>(
      a, w, scalars, y, ops, M, K, N, n_r1, n_r2, m, nu, uniform);
}

}  // namespace

// a: (M, K) f32 row-major; w: (K, N) f32 row-major; scalars: [delta_r1,
// bias, grid] f32 on the device; y: (M, N) f32 out; ops: one int64 the
// caller zeroed, incremented by the valid region's comparator cycles.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int trq_group_mvm_launch(const float* a, const float* w,
                                    const float* scalars, float* y,
                                    unsigned long long* ops, int M, int K,
                                    int N, int n_r1, int n_r2, int m, int nu,
                                    int uniform, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    // decode shapes: 16x32 tiles keep enough blocks in flight at small M
    launch<16, 8, 1>(a, w, scalars, y, ops, M, K, N, n_r1, n_r2, m, nu,
                     uniform, s);
  } else {
    launch<16, 16, 4>(a, w, scalars, y, ops, M, K, N, n_r1, n_r2, m, nu,
                      uniform, s);
  }
  return static_cast<int>(cudaGetLastError());
}
