// Signed/unsigned twin-range quantizer (TRQ, paper Eq. 1/7/8) and its SAR
// comparator-cycle count (Eq. 6), as device functions shared by the port's
// CUDA kernels.
//
// Every rounding step is spelled out with an IEEE round-to-nearest
// intrinsic (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn): the floor
// boundaries of the quantizer are sensitive to the last ulp, so a division
// must be correctly rounded and no multiply-add may be contracted into an
// FMA.  Mirrors repro_torch/core/trq.py (and repro/core/trq.py) operation
// for operation.  Never build this with --use_fast_math.
#pragma once

struct TrqRegs {
  float delta_r1;
  float delta_r2;   // delta_r1 * 2^m
  float offset;     // bias * 2^n_r1 * delta_r1
  float theta;      // offset + 2^n_r1 * delta_r1
  int n_r1;
  int n_r2;
  int nu;
  bool uniform;     // plain N_R2-bit ADC (mode == "uniform")
};

__device__ __forceinline__ TrqRegs trq_regs(float delta_r1, float bias,
                                            int n_r1, int n_r2, int m,
                                            int nu, bool uniform) {
  TrqRegs r;
  const float p1 = (float)(1 << n_r1);          // exact powers of two
  r.delta_r1 = delta_r1;
  r.delta_r2 = __fmul_rn(delta_r1, (float)(1 << m));
  r.offset = __fmul_rn(__fmul_rn(bias, p1), delta_r1);
  r.theta = __fadd_rn(r.offset, __fmul_rn(p1, delta_r1));
  r.n_r1 = n_r1;
  r.n_r2 = n_r2;
  r.nu = nu;
  r.uniform = uniform;
  return r;
}

// Q_k(x, delta) of Eq. 1: floor(x/delta + 0.5) clipped to [0, 2^k - 1].
// floor(x + 0.5), not rint: the SAR search rounds half away from zero.
__device__ __forceinline__ float trq_uniform(float x, float delta, int k) {
  float c = floorf(__fadd_rn(__fdiv_rn(x, delta), 0.5f));
  c = fminf(fmaxf(c, 0.0f), (float)((1 << k) - 1));
  return __fmul_rn(__fadd_rn(c, 0.0f), delta);  // -0 -> +0
}

// Unsigned TRQ T(x) of Eq. 7.  Returns the quantized value and stores the
// conversion's comparator cycles in *ops: twin mode nu + (n_r1 if x is in
// R1 = [offset, theta) else n_r2), uniform mode n_r2.
__device__ __forceinline__ float trq_unsigned(float x, const TrqRegs& r,
                                              int* ops) {
  if (r.uniform) {
    *ops = r.n_r2;
    return trq_uniform(x, r.delta_r2, r.n_r2);
  }
  if ((x >= r.offset) && (x < r.theta)) {
    *ops = r.nu + r.n_r1;
    return __fadd_rn(r.offset,
                     trq_uniform(__fsub_rn(x, r.offset), r.delta_r1, r.n_r1));
  }
  *ops = r.nu + r.n_r2;
  return trq_uniform(x, r.delta_r2, r.n_r2);
}

// Signed TRQ: sign(x) * T(|x|), counting the cycles of T(|x|).
__device__ __forceinline__ float trq_signed(float x, const TrqRegs& r,
                                            int* ops) {
  const float t = trq_unsigned(fabsf(x), r, ops);
  const float s = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
  return __fmul_rn(s, t);
}
