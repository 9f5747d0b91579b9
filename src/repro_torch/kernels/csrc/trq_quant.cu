// trq_quant: elementwise TRQ fake-quant and SAR comparator-cycle count.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/trq_quant/kernel.py::trq_quant_tiles (body _kernel)
// For every element x:  q   = T(x)            (unsigned)
//                       q   = sign(x)*T(|x|)  (signed)
//                       ops = nu + (n_r1 if in R1 else n_r2), or n_r2 in
//                             uniform mode
//
// Bound on an H100: the kernel reads 4 bytes (f32; 2 for f16) and writes 8
// bytes per element for a few dozen ALU operations, far below the card's
// ridge point — it is bound by HBM bytes.  The design therefore does no
// tiling and no padding: one thread per element of the flattened tensor,
// grid-stride, neighbouring threads on neighbouring addresses so every load
// and store coalesces; the registers [delta_r1, bias] are read once per
// thread from a device pointer (the calibration loop writes candidates on
// the card, so the host never syncs).  The quantizer is trq.cuh's, the same
// device function K1 and K3 call, so the three kernels agree bit for bit.
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
