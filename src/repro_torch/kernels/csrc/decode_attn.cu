// decode_attn: one-row (decode) attention against a cache, in two entries,
// every sum in an order fixed by the shapes of one head.
//
// Replaces no Pallas kernel: the reference's decode attention is plain jnp
// (repro/models/attention.py::decode_attention, and full_attention on one
// query row for the cross-attention of an encoder-decoder), which the port
// ran as two batched cuBLAS products.  cuBLAS picks a batched product's
// kernel, and with it each dot's summation order (split-K or not), by the
// batch count, so a rank that holds a share of the KV heads at decode
// (dist.group.HeadShare) summed its heads otherwise than one device
// holding them all.  Here each output is summed by one thread, or by a
// fixed tree over a fixed number of threads, whatever the number of heads
// in the call, so a head's arithmetic is the same on a share as whole.
//
// Scores entry (decode_attn_scores_launch):
//   s[b, h, g, j] = sum_d q[b, h, g, d] * k[b, j, h, d]
// q is f32 (the caller scaled it, and rounded it to the cache's dtype where
// the reference does); k is f32, f16 or bf16 with its own strides (the
// last dim contiguous).  One block a (b, h) and 32 keys, q's G x hd values
// of that head in shared memory; one warp a key, its row read once into
// registers (lane l holds dims l, l + 32, ...); for each of the G query
// rows a lane's fmaf chain over its dims, then a butterfly over the 32
// lanes.  Bound: bytes (the cache is read once, 2 x hd FLOP a key and
// query row).
//
// Values entry (decode_attn_values_launch):
//   a = softmax over j of (j < len[b] ? s : NEG_INF), optionally rounded to
//   the cache's dtype (the reference's a.astype(v.dtype)); o = a . v
// One block a (b, h, g) row of 256 threads.  The max (exact in any order),
// the sum of exp(s - max) (a strided loop over j, then a fixed shuffle
// tree), a held in shared memory 1,024 keys at a time, and the product: 256
// / hd groups of hd lanes, group i summing the keys j = i mod groups in
// increasing order, the groups then added in order.  Keys past len add
// exact zeros in the plain version and are skipped here.  Bound: bytes
// (s and v read once).
//
// No atomics: a call gives the same bits every time, and a head's bits do
// not depend on the other heads in the call.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKeys = 32;         // keys a scores block (a warp a key)
constexpr int kDimsPerLane = 8;   // hd <= 256: a lane's dims of a key
constexpr int kThreads = 256;     // threads a block
constexpr int kTile = 1024;       // probabilities a values block holds
constexpr float kNegInf = -1e30f; // models/attention.py's NEG_INF

template <typename T>
__device__ __forceinline__ float widen(T v);
template <>
__device__ __forceinline__ float widen<float>(float v) { return v; }
template <>
__device__ __forceinline__ float widen<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round an f32 to T (nearest even) and back
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__half>(float v) {
  return __half2float(__float2half_rn(v));
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const float* __restrict__ q, const T* __restrict__ k,
              float* __restrict__ s, int heads, int groups, int hd, int keys,
              long long k_sb, long long k_ss, long long k_sh) {
  extern __shared__ float qh[];                      // groups x hd
  const int bh = blockIdx.y;                         // b * heads + h
  const int b = bh / heads, h = bh % heads;
  const float* qrow = q + (long long)bh * groups * hd;
  for (int i = threadIdx.x; i < groups * hd; i += blockDim.x) qh[i] = qrow[i];
  __syncthreads();
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* srow = s + (long long)bh * groups * keys;
  const int end = min(keys, (blockIdx.x + 1) * kKeys);
  for (int j = blockIdx.x * kKeys + w; j < end; j += kThreads / 32) {
    // lane l holds the key's dims l, l + 32, ... (a coalesced row read)
    const T* kr = k + b * k_sb + j * k_ss + h * k_sh;
    float kv[kDimsPerLane];
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      kv[i] = d < hd ? widen<T>(kr[d]) : 0.f;
    }
    for (int g = 0; g < groups; ++g) {
      const float* qg = qh + g * hd;
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) p = fmaf(qg[d], kv[i], p);
      }
      // a butterfly: every lane ends with the same bits (f32 addition
      // commutes), in an order fixed by hd alone
      for (int o = 16; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (lane == 0) srow[(long long)g * keys + j] = p;
    }
  }
}

// a fixed tree over the block's 256 threads: each warp by shuffles, then
// warp 0 over the 8 warp results; every thread gets the total
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.f;
    for (int o = 4; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    v = lane < kThreads / 32 ? red[lane] : -INFINITY;
    for (int o = 4; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
values_kernel(const float* __restrict__ s, const T* __restrict__ v,
              const int32_t* __restrict__ lens, float* __restrict__ o,
              int heads, int groups, int hd, int keys, long long v_sb,
              long long v_ss, long long v_sh, int round_a) {
  __shared__ float a[kTile];
  __shared__ float part[kThreads];
  __shared__ float red[kThreads / 32];
  const int row = blockIdx.x;                        // (b*heads + h)*groups + g
  const int bh = row / groups;
  const int b = bh / heads, h = bh % heads;
  const float* sr = s + (long long)row * keys;
  // keys that enter: those below len; none valid (len <= 0) masks every
  // key, a uniform softmax over all of them, as the plain version gives
  int n = keys;
  bool none = false;
  if (lens != nullptr) {
    const int len = lens[b];
    none = len <= 0;
    if (!none && len < keys) n = len;
  }
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kThreads)
    m = fmaxf(m, none ? kNegInf : sr[j]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads)
    sum += expf((none ? kNegInf : sr[j]) - m);
  sum = block_sum(sum, red);

  const int lanes = hd, nglanes = kThreads / hd;
  const int d = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  const T* vp = v + b * v_sb + h * v_sh + d;
  float acc = 0.f;
  for (int base = 0; base < n; base += kTile) {
    const int cnt = n - base < kTile ? n - base : kTile;
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      const float p = expf((none ? kNegInf : sr[base + i]) - m) / sum;
      a[i] = round_a ? round_to<T>(p) : p;
    }
    __syncthreads();
    if (grp < nglanes) {
#pragma unroll 8
      for (int i = grp; i < cnt; i += nglanes)
        acc = fmaf(a[i], widen<T>(vp[(long long)(base + i) * v_ss]), acc);
    }
  }
  __syncthreads();
  if (grp < nglanes) part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < hd) {
    float r = part[threadIdx.x];
    for (int i = 1; i < nglanes; ++i) r += part[i * hd + threadIdx.x];
    o[(long long)row * hd + threadIdx.x] = r;
  }
}

template <typename T>
int scores_as(const float* q, const void* k, float* s, int batch, int heads,
              int groups, int hd, int keys, long long k_sb, long long k_ss,
              long long k_sh, cudaStream_t st) {
  const dim3 grid((unsigned)((keys + kKeys - 1) / kKeys),
                  (unsigned)(batch * heads));
  const size_t smem = sizeof(float) * groups * hd;
  scores_kernel<T><<<grid, kThreads, smem, st>>>(
      q, static_cast<const T*>(k), s, heads, groups, hd, keys, k_sb, k_ss,
      k_sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int values_as(const float* s, const void* v, const int32_t* lens, float* o,
              int batch, int heads, int groups, int hd, int keys,
              long long v_sb, long long v_ss, long long v_sh, int round_a,
              cudaStream_t st) {
  values_kernel<T><<<batch * heads * groups, kThreads, 0, st>>>(
      s, static_cast<const T*>(v), lens, o, heads, groups, hd, keys, v_sb,
      v_ss, v_sh, round_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 f16, 2 bf16.  q (B, H, G, hd) f32 contiguous; k strides
// in elements; s (B, H, G, keys) f32.  hd in [1, 256], G x hd <= 12,288.
extern "C" int decode_attn_scores_launch(const float* q, const void* k,
                                         int dtype, float* s, int batch,
                                         int heads, int groups, int hd,
                                         int keys, long long k_sb,
                                         long long k_ss, long long k_sh,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || heads < 1 || groups < 1 || hd < 1 || hd > kThreads ||
      keys < 1 || (long long)groups * hd > 12288 ||
      (long long)batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0:
      return scores_as<float>(q, k, s, batch, heads, groups, hd, keys, k_sb,
                              k_ss, k_sh, st);
    case 1:
      return scores_as<__half>(q, k, s, batch, heads, groups, hd, keys, k_sb,
                               k_ss, k_sh, st);
    case 2:
      return scores_as<__nv_bfloat16>(q, k, s, batch, heads, groups, hd, keys,
                                      k_sb, k_ss, k_sh, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// s (B, H, G, keys) f32 contiguous; v strides in elements; lens (B,) int32
// or null (every key enters); o (B, H, G, hd) f32.  round_a: round each
// probability to v's dtype before the product.
extern "C" int decode_attn_values_launch(const float* s, const void* v,
                                         int dtype, const int32_t* lens,
                                         float* o, int batch, int heads,
                                         int groups, int hd, int keys,
                                         long long v_sb, long long v_ss,
                                         long long v_sh, int round_a,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch < 1 || heads < 1 || groups < 1 || hd < 1 || hd > kThreads ||
      keys < 1 || (long long)batch * heads * groups > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dtype) {
    case 0:
      return values_as<float>(s, v, lens, o, batch, heads, groups, hd, keys,
                              v_sb, v_ss, v_sh, round_a, st);
    case 1:
      return values_as<__half>(s, v, lens, o, batch, heads, groups, hd, keys,
                               v_sb, v_ss, v_sh, round_a, st);
    case 2:
      return values_as<__nv_bfloat16>(s, v, lens, o, batch, heads, groups, hd,
                                       keys, v_sb, v_ss, v_sh, round_a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
