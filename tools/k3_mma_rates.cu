// Rates of the tensor-core instructions K3 (xbar_mvm) can form its bit-line
// sums with, on the card it runs on, and a check of each fragment layout.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o k3_mma_rates tools/k3_mma_rates.cu && ./k3_mma_rates
//
// Variants, each a loop of independent mma.sync chains in every warp of
// 4 blocks per SM:
//   s8        mma.m16n8k32.s8.s8.s32 on operands already in registers;
//   s8+expand the same, with the B operand expanded from a packed 0/1 mask
//             in registers each time (nibble * 0x204081 & 0x01010101), as
//             K3 does with its weight masks;
//   b1 k128   mma.m16n8k128.b1.b1.s32.and.popc (one 128-row crossbar group
//             per instruction, operands the packed mask words as they are);
//   b1 k256   mma.m16n8k256.b1.b1.s32.and.popc;
// then the latency of a dependent chain of s8 and b1 mmas in one warp, and
// the b1 rate with one warp per SM sub-partition keeping 1 to 16
// independent mmas in flight.
// Rates are "operations" as the data sheet counts them: 2 M N K per mma
// (a one-bit AND-popcount step counts as one multiply-add).  Prints one
// line per variant and a JSON line at the end.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#define CHECK(x)                                                        \
  do {                                                                  \
    cudaError_t e = (x);                                                \
    if (e != cudaSuccess) {                                             \
      fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,                 \
              cudaGetErrorString(e));                                   \
      exit(1);                                                          \
    }                                                                   \
  } while (0)

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_b1_k128(int (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void mma_b1_k256(int (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t expand4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

constexpr int kChains = 8;

template <int V>
__global__ void __launch_bounds__(256) rate_kernel(int iters, uint32_t seed,
                                                   int* out) {
  int d[kChains][4];
#pragma unroll
  for (int j = 0; j < kChains; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0;
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = (seed + threadIdx.x * 7u + i) & 0x01010101u;
  uint32_t w = seed ^ threadIdx.x;
  const int tig = threadIdx.x & 3;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if (V == 0) {
        mma_s8(d[j], a, a[j & 3], a[(j + 1) & 3]);
      } else if (V == 1) {
        w = w * 1664525u + 1013904223u;
        mma_s8(d[j], a, expand4((w >> (4 * tig)) & 0xFu),
               expand4((w >> (4 * tig + 16)) & 0xFu));
      } else if (V == 2) {
        mma_b1_k128(d[j], a[0] ^ it, a[1], a[j & 3]);
      } else {
        mma_b1_k256(d[j], a, a[j & 3] ^ it, a[(j + 1) & 3]);
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One warp: D = A (16 x K) . B (K x 8) through each fragment layout, for
// the host to compare with its own product.
__global__ void layout_kernel(const uint32_t* a_words, const uint32_t* b_words,
                              const int8_t* a8, const int8_t* b8, int* d_b1,
                              int* d_s8) {
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  // b1 k128: a_words (16 rows x 4 words), b_words (8 cols x 4 words)
  int d[4] = {0, 0, 0, 0};
  mma_b1_k128(d, a_words[gid * 4 + tig], a_words[(gid + 8) * 4 + tig],
              b_words[gid * 4 + tig]);
  d_b1[gid * 8 + 2 * tig] = d[0];
  d_b1[gid * 8 + 2 * tig + 1] = d[1];
  d_b1[(gid + 8) * 8 + 2 * tig] = d[2];
  d_b1[(gid + 8) * 8 + 2 * tig + 1] = d[3];
  // s8 k32: a8 (16 x 32 row-major), b8 (8 cols x 32, column-major)
  auto w4 = [](const int8_t* p) {
    return (uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[1] << 8) |
           ((uint32_t)(uint8_t)p[2] << 16) | ((uint32_t)(uint8_t)p[3] << 24);
  };
  uint32_t a[4] = {w4(a8 + gid * 32 + 4 * tig), w4(a8 + (gid + 8) * 32 + 4 * tig),
                   w4(a8 + gid * 32 + 16 + 4 * tig),
                   w4(a8 + (gid + 8) * 32 + 16 + 4 * tig)};
  int e[4] = {0, 0, 0, 0};
  mma_s8(e, a, w4(b8 + gid * 32 + 4 * tig), w4(b8 + gid * 32 + 16 + 4 * tig));
  d_s8[gid * 8 + 2 * tig] = e[0];
  d_s8[gid * 8 + 2 * tig + 1] = e[1];
  d_s8[(gid + 8) * 8 + 2 * tig] = e[2];
  d_s8[(gid + 8) * 8 + 2 * tig + 1] = e[3];
}

static bool check_layouts() {
  uint32_t aw[64], bw[32];
  int8_t a8[512], b8[256];
  srand(1);
  for (auto& x : aw) x = ((uint32_t)rand() << 16) ^ (uint32_t)rand();
  for (auto& x : bw) x = ((uint32_t)rand() << 16) ^ (uint32_t)rand();
  for (auto& x : a8) x = rand() & 1;
  for (auto& x : b8) x = rand() & 1;
  uint32_t *daw, *dbw;
  int8_t *da8, *db8;
  int *dd1, *dd8;
  CHECK(cudaMalloc(&daw, sizeof aw));
  CHECK(cudaMalloc(&dbw, sizeof bw));
  CHECK(cudaMalloc(&da8, sizeof a8));
  CHECK(cudaMalloc(&db8, sizeof b8));
  CHECK(cudaMalloc(&dd1, 128 * sizeof(int)));
  CHECK(cudaMalloc(&dd8, 128 * sizeof(int)));
  CHECK(cudaMemcpy(daw, aw, sizeof aw, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(dbw, bw, sizeof bw, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(da8, a8, sizeof a8, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(db8, b8, sizeof b8, cudaMemcpyHostToDevice));
  layout_kernel<<<1, 32>>>(daw, dbw, da8, db8, dd1, dd8);
  CHECK(cudaGetLastError());
  int h1[128], h8[128];
  CHECK(cudaMemcpy(h1, dd1, sizeof h1, cudaMemcpyDeviceToHost));
  CHECK(cudaMemcpy(h8, dd8, sizeof h8, cudaMemcpyDeviceToHost));
  int bad1 = 0, bad8 = 0;
  for (int r = 0; r < 16; ++r)
    for (int n = 0; n < 8; ++n) {
      int want1 = 0, want8 = 0;
      for (int q = 0; q < 4; ++q) want1 += __builtin_popcount(aw[r * 4 + q] & bw[n * 4 + q]);
      for (int k = 0; k < 32; ++k) want8 += a8[r * 32 + k] * b8[n * 32 + k];
      bad1 += h1[r * 8 + n] != want1;
      bad8 += h8[r * 8 + n] != want8;
    }
  printf("layout check: b1 k128 %d/128 wrong, s8 k32 %d/128 wrong\n", bad1, bad8);
  cudaFree(daw); cudaFree(dbw); cudaFree(da8); cudaFree(db8);
  cudaFree(dd1); cudaFree(dd8);
  return bad1 == 0 && bad8 == 0;
}

// Latency: one warp, a chain of dependent mmas (each accumulates into the
// last one's result); cycles per mma from clock64.
template <int V>
__global__ void latency_kernel(int iters, uint32_t seed, long long* cycles,
                               int* out) {
  int d[4] = {0, 0, 0, 0};
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = (seed + threadIdx.x * 7u + i) & 0x01010101u;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (V == 0) mma_s8(d, a, a[0], a[1]);
    else mma_b1_k128(d, a[0], a[1], a[2]);
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
  out[threadIdx.x] = d[0] + d[1] + d[2] + d[3];
}

// One warp per SM sub-partition (4 per SM), `chains` independent chains in
// each: how many mmas a warp must keep in flight to reach the rate.
template <int CH>
__global__ void __launch_bounds__(128) inflight_kernel(int iters, uint32_t seed,
                                                       int* out) {
  int d[CH][4];
#pragma unroll
  for (int j = 0; j < CH; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0;
  const uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3u, b = a0 * 7u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CH; ++j) mma_b1_k128(d[j], a0 ^ it, a1, b + j);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < CH; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CH>
static double inflight_rate(int sms, int* out, cudaEvent_t t0, cudaEvent_t t1) {
  const int iters = 8192;
  inflight_kernel<CH><<<sms, 128>>>(16, 1u, out);
  CHECK(cudaDeviceSynchronize());
  CHECK(cudaEventRecord(t0));
  inflight_kernel<CH><<<sms, 128>>>(iters, 1u, out);
  CHECK(cudaEventRecord(t1));
  CHECK(cudaEventSynchronize(t1));
  float ms;
  CHECK(cudaEventElapsedTime(&ms, t0, t1));
  return (double)sms * 4 * iters * CH / (ms * 1e-3);
}

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  const bool ok = check_layouts();
  const int blocks = prop.multiProcessorCount * 4, threads = 256, iters = 4096;
  int* out;
  CHECK(cudaMalloc(&out, blocks * threads * sizeof(int)));
  const char* names[4] = {"s8", "s8+expand", "b1 k128", "b1 k256"};
  const double k_of[4] = {32, 32, 128, 256};
  double tops[4];
  cudaEvent_t t0, t1;
  CHECK(cudaEventCreate(&t0));
  CHECK(cudaEventCreate(&t1));
  for (int v = 0; v < 4; ++v) {
    auto run = [&](int it) {
      switch (v) {
        case 0: rate_kernel<0><<<blocks, threads>>>(it, 1u, out); break;
        case 1: rate_kernel<1><<<blocks, threads>>>(it, 1u, out); break;
        case 2: rate_kernel<2><<<blocks, threads>>>(it, 1u, out); break;
        default: rate_kernel<3><<<blocks, threads>>>(it, 1u, out); break;
      }
    };
    run(16);
    CHECK(cudaDeviceSynchronize());
    float best = 1e30f;
    for (int rep = 0; rep < 3; ++rep) {
      CHECK(cudaEventRecord(t0));
      run(iters);
      CHECK(cudaEventRecord(t1));
      CHECK(cudaEventSynchronize(t1));
      float ms;
      CHECK(cudaEventElapsedTime(&ms, t0, t1));
      if (ms < best) best = ms;
    }
    CHECK(cudaGetLastError());
    const double mmas = (double)blocks * (threads / 32) * iters * kChains;
    tops[v] = mmas * 2.0 * 16 * 8 * k_of[v] / (best * 1e-3) / 1e12;
    printf("%-10s %9.3f ms  %8.1f TOP/s  %.3e mma/s\n", names[v], best, tops[v],
           mmas / (best * 1e-3));
  }
  // latency of a dependent chain, one warp
  long long* cyc;
  CHECK(cudaMalloc(&cyc, sizeof(long long)));
  double lat[2];
  for (int v = 0; v < 2; ++v) {
    for (int rep = 0; rep < 2; ++rep) {
      if (v == 0) latency_kernel<0><<<1, 32>>>(4096, 1u, cyc, out);
      else latency_kernel<1><<<1, 32>>>(4096, 1u, cyc, out);
      CHECK(cudaDeviceSynchronize());
    }
    long long c;
    CHECK(cudaMemcpy(&c, cyc, sizeof c, cudaMemcpyDeviceToHost));
    lat[v] = (double)c / 4096;
  }
  printf("latency: s8 k32 %.1f cycles, b1 k128 %.1f cycles per dependent mma\n",
         lat[0], lat[1]);
  const double r1 = inflight_rate<1>(prop.multiProcessorCount, out, t0, t1);
  const double r2 = inflight_rate<2>(prop.multiProcessorCount, out, t0, t1);
  const double r4 = inflight_rate<4>(prop.multiProcessorCount, out, t0, t1);
  const double r8 = inflight_rate<8>(prop.multiProcessorCount, out, t0, t1);
  const double r16 = inflight_rate<16>(prop.multiProcessorCount, out, t0, t1);
  printf("b1 k128, one warp per sub-partition, chains in flight 1/2/4/8/16: "
         "%.3e %.3e %.3e %.3e %.3e mma/s\n", r1, r2, r4, r8, r16);
  printf("{\"latency_cycles\": {\"s8\": %.1f, \"b1_k128\": %.1f}, "
         "\"b1_inflight_mma_per_s\": [%.4e, %.4e, %.4e, %.4e, %.4e]}\n",
         lat[0], lat[1], r1, r2, r4, r8, r16);
  printf("{\"device\": \"%s\", \"sms\": %d, \"layouts_ok\": %s, \"tops\": "
         "{\"s8\": %.1f, \"s8_expand\": %.1f, \"b1_k128\": %.1f, "
         "\"b1_k256\": %.1f}}\n",
         prop.name, prop.multiProcessorCount, ok ? "true" : "false", tops[0],
         tops[1], tops[2], tops[3]);
  return ok ? 0 : 1;
}
