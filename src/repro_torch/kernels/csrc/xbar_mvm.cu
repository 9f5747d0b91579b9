// xbar_mvm: the bit-exact ISAAC sliced crossbar MVM with one (TRQ-)ADC
// conversion per bit-line partial sum, plus the SAR comparator-cycle count.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/xbar_mvm/kernel.py::xbar_mvm_tiles (body _kernel)
// For each 128-row group g, input bit b and weight bit c:
//   psum = sum over the group's rows of a_bit[b] * u_bit[c]   (in [0, 128])
//   q    = T(psum) (unsigned TRQ)   or psum (lossless)
//   ops += nu + (n_r1 | n_r2), n_r2 (uniform)   or r_adc (lossless)
//   acc_g += q * 2^(b+c)                 (acc_g fresh per group, f32)
// and out += acc_g after each group: the TPU kernel's order (group outer,
// b, then c).  The launcher subtracts the offset-encoding correction
// zp * rowsum(a) outside the kernel.
//
// Design for the card, not block by block.  A 0/1 plane product over 128
// rows is a popcount: the operands arrive as bit masks, four 32-bit words
// per (plane, row or column, group) — activations (k_i, M, G, 4), weights
// (k_w, G, N, 4), one bit per cell, so the weight image is 1 byte per
// weight — and psum = sum_q __popc(a[q] & w[q]) is exact in integers; no
// float product happens at all.  psum takes only 129 values, so each block
// tabulates the quantizer (q, ops) for 0..128 in shared memory from the
// launch's registers with trq.cuh's device function — identical to calling
// it per conversion.  Each thread owns one output column and keeps that
// column's k_w x 4 weight words of the current group in registers; the
// warp shares its rows, so every activation word is a broadcast load.
// Ragged edges: rows past K in the last group are zero bits in both masks
// (the partial crossbar still converts every bit-line, as the reference
// pads); columns past N and rows past M load nothing, store nothing and
// count no ops.  The op total is reduced per warp into one int64 counter;
// the per-output counts (int32) are written only when asked for.
//
// Bound on an H100: the packed weights (K*N bytes) are read once, and the
// work is k_i*k_w*M*K*N one-bit multiply-accumulates, which int8 tensor
// cores would do at 1,979 TOP/s: decode shapes (M = 4) are bound by the
// weight bytes, prefill shapes (M = 64) by the operations.  This first
// version runs on the integer pipes (__popc at a quarter of the ALU rate)
// with no tensor cores and unpipelined loads; int8 mma/wgmma on the planes
// and cp.async staging are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "trq.cuh"

namespace {

constexpr int kXbar = 128;      // crossbar rows per group
constexpr int kWords = 4;       // 32-bit mask words per 128-row group
constexpr int kMaxBits = 8;     // k_i, k_w <= 8
constexpr int kWarps = 4;       // warps per block, each on its own rows
constexpr int kCols = 32;       // output columns per block (one per lane)

template <int RPT>
__global__ void __launch_bounds__(kWarps * 32)
xbar_mvm_kernel(const uint4* __restrict__ a_mask,
                const uint4* __restrict__ w_mask,
                const float* __restrict__ scalars, float* __restrict__ out,
                int32_t* __restrict__ ops_out,
                unsigned long long* __restrict__ ops_total, int M, int G,
                int N, int k_i, int k_w, int n_r1, int n_r2, int m, int nu,
                int uniform, int lossless, int r_adc) {
  __shared__ float tab_q[kXbar + 1];
  __shared__ int tab_ops[kXbar + 1];
  if (lossless) {
    for (int i = threadIdx.x; i <= kXbar; i += blockDim.x) {
      tab_q[i] = (float)i;
      tab_ops[i] = r_adc;
    }
  } else {
    const TrqRegs regs =
        trq_regs(scalars[0], scalars[1], n_r1, n_r2, m, nu, uniform != 0);
    for (int i = threadIdx.x; i <= kXbar; i += blockDim.x) {
      int o;
      tab_q[i] = trq_unsigned((float)i, regs, &o);
      tab_ops[i] = o;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kCols + lane;
  const bool col_ok = n < N;
  const int row0 = (blockIdx.y * kWarps + warp) * RPT;

  float acc[RPT];
  int ops_row[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    acc[r] = 0.0f;
    ops_row[r] = 0;
  }

  for (int g = 0; g < G; ++g) {
    uint4 wv[kMaxBits];
#pragma unroll
    for (int c = 0; c < kMaxBits; ++c) {
      wv[c] = make_uint4(0u, 0u, 0u, 0u);
      if (c < k_w && col_ok) wv[c] = w_mask[((size_t)c * G + g) * N + n];
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = row0 + r;
      if (row >= M) break;                    // uniform across the warp
      float acc_g = 0.0f;
      int o = 0;
      for (int b = 0; b < k_i; ++b) {
        const uint4 av = a_mask[((size_t)b * M + row) * G + g];
#pragma unroll
        for (int c = 0; c < kMaxBits; ++c) {
          if (c < k_w) {
            const int ps = __popc(av.x & wv[c].x) + __popc(av.y & wv[c].y) +
                           __popc(av.z & wv[c].z) + __popc(av.w & wv[c].w);
            acc_g = __fadd_rn(acc_g,
                              __fmul_rn(tab_q[ps], (float)(1u << (b + c))));
            o += tab_ops[ps];
          }
        }
      }
      acc[r] = __fadd_rn(acc[r], acc_g);
      ops_row[r] += o;
    }
  }

  unsigned long long my_ops = 0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r;
    if (row < M && col_ok) {
      out[(size_t)row * N + n] = acc[r];
      if (ops_out != nullptr) ops_out[(size_t)row * N + n] = ops_row[r];
      my_ops += (unsigned long long)ops_row[r];
    }
  }
  // op total: warp reduction, then one 64-bit atomic per warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_ops += __shfl_down_sync(0xffffffffu, my_ops, off);
  if (lane == 0 && my_ops) atomicAdd(ops_total, my_ops);
}

template <int RPT>
void launch(const uint4* a, const uint4* w, const float* scalars, float* out,
            int32_t* ops_out, unsigned long long* ops_total, int M, int G,
            int N, int k_i, int k_w, int n_r1, int n_r2, int m, int nu,
            int uniform, int lossless, int r_adc, cudaStream_t stream) {
  const dim3 grid((N + kCols - 1) / kCols,
                  (M + kWarps * RPT - 1) / (kWarps * RPT));
  xbar_mvm_kernel<RPT><<<grid, kWarps * 32, 0, stream>>>(
      a, w, scalars, out, ops_out, ops_total, M, G, N, k_i, k_w, n_r1, n_r2,
      m, nu, uniform, lossless, r_adc);
}

}  // namespace

// a_mask: (k_i, M, G, 4) uint32 activation bit masks; w_mask: (k_w, G, N, 4)
// uint32 offset-encoded weight bit masks (bit r of word q <-> row
// g*128 + 32*q + r); scalars: [delta_r1, bias] f32 on the device (unused
// when lossless); out: (M, N) f32, before the zero-point correction;
// ops_out: (M, N) int32 per-output counts, or null; ops_total: one int64
// the caller zeroed.  Returns cudaGetLastError() after the launch.
extern "C" int xbar_mvm_launch(const void* a_mask, const void* w_mask,
                               const float* scalars, float* out,
                               int32_t* ops_out,
                               unsigned long long* ops_total, int M, int G,
                               int N, int k_i, int k_w, int n_r1, int n_r2,
                               int m, int nu, int uniform, int lossless,
                               int r_adc, void* stream) {
  if (k_i < 1 || k_i > kMaxBits || k_w < 1 || k_w > kMaxBits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* a = static_cast<const uint4*>(a_mask);
  const uint4* w = static_cast<const uint4*>(w_mask);
  if (M <= kWarps) {
    // decode shapes: one row per warp keeps N/32 blocks of 4 warps busy
    launch<1>(a, w, scalars, out, ops_out, ops_total, M, G, N, k_i, k_w,
              n_r1, n_r2, m, nu, uniform, lossless, r_adc, s);
  } else {
    launch<4>(a, w, scalars, out, ops_out, ops_total, M, G, N, k_i, k_w,
              n_r1, n_r2, m, nu, uniform, lossless, r_adc, s);
  }
  return static_cast<int>(cudaGetLastError());
}
