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
// Operands are bit masks, four 32-bit words per (plane, row or column,
// group): activations (k_i, M, G, 4), weights (k_w, G, N, 4), bit r of word
// q <-> row g*128 + 32*q + r.  The weight image is 1 byte per weight.
//
// Bound on an H100.  The packed weights (K*N bytes at k_w = 8) are read
// once; the work is k_i*k_w*M*K*N one-bit multiply-adds.  Counted at the
// one-bit tensor-core rate (9.06e15 operations/s, the highest that
// tools/k3_mma_rates.cu measured, with mma.m16n8k256; the data sheet
// gives none), the decode shapes (M = 4) and the continued prefill
// (M = 16) are bound by the weight bytes (0.0076 ms for w_gate
// 4 x 3072 x 8192 at 3.35 TB/s) and the prefill shapes (M = 64) by the
// operations (0.0227 ms for w_down 64 x 8192 x 3072).
//
// Design.
// * Bit-line sums on the tensor cores: mma.m16n8k128.b1.b1.s32.and.popc
//   forms one whole 128-row group of AND-popcounts per instruction from
//   the packed words as they are.  Sums of up to 128 ones are exact in
//   s32.  tools/k3_mma_rates.cu measured 7.3e15 such bit operations/s on
//   the card: 6.6x the int8 mma.m16n8k32 rate on 0/1 bytes, 16x that rate
//   with the bytes expanded from the masks in registers, so the int8 route
//   was not taken.
// * The fragments put every sum of an output in the thread that converts
//   it.  A warp owns TM rows x 4 columns of the output.  The n8 tile's
//   columns are (column, weight bit c) pairs, 4 columns x 2 bits, so lane
//   (gid, tig) receives columns 2 tig, 2 tig + 1 = bits c, c + 1 of column
//   tig.  The m16 tile's rows are (row, input bit b) pairs: rows gid and
//   gid + 8 are bits b, b + 1 of one row.  For TM = 8, row gid of the
//   tile is row gid of M; 4 tiles cover b = 0..7, so the thread holds all
//   64 sums of its output.  For TM = 4, row gid is row gid & 3 and the
//   half gid >> 2 takes b = 0..3 or 4..7: two lanes (lane, lane ^ 16)
//   share an output, 32 sums each.
// * The conversion epilogue in the TPU kernel's order, from registers.
//   The quantizer is a table of (q, ops) for sums 0..128, built once per
//   block from the launch's registers with trq.cuh's device function (so a
//   lookup equals a call), one copy per lane (address = sum * 256 + lane
//   * 4: lookups never conflict).  A thread issues its lookups, then runs
//   the dependent chain acc_g = fma(q, 2^(b+c), acc_g), b outer and c
//   inner (the fma of the exact product equals the reference's add).  For
//   TM = 4 the low half runs b = 0..3 and passes its partial to the high
//   half by one shuffle; the high half's table copies hold 16 q (exact),
//   so the same chain continues with b = 4..7.  When every sum costs the
//   same ops (lossless, uniform, or n_r1 == n_r2) the ops lookups are
//   skipped.
// * Every SM busy at decode.  A block is 8 consumer warps (TM x 32
//   outputs) and one producer warp, over a contiguous slice of the groups;
//   up to 8 blocks of one thread-block cluster split the groups of one
//   output tile (the wrapper's shape plan, kernels/xbar_mvm/kernel.py::
//   plan: the largest split that keeps one wave of blocks).  A split block
//   keeps acc_g per group in shared memory; after a cluster barrier each
//   block gathers a share of the tile's outputs from its peers through
//   distributed shared memory and folds them over all groups in ascending
//   order.  Without a split a block folds in registers.  No float atomics,
//   no scratch in device memory, one launch: the order never changes from
//   run to run.
// * Loads in flight: the producer warp keeps a ring of 4 stages of the
//   weight tile (k_w planes of 32 columns x 16 bytes, one 1-D bulk copy
//   each) in flight on mbarriers; each consumer warp releases a stage once
//   it holds its B fragments, after a proxy fence (the refill is an
//   async-proxy write into the memory its lanes just read).  The
//   activation words are tiny and come from L2, loaded one group ahead.
// Against the bounds (PERF.md has the times): at decode the weight stream
// keeps up (a flush that leaves L2 clean gives the same time) and the
// conversions are the limit; at prefill the kernel stays well above the
// one-bit operations bound, and the conversions are again the limit: one
// shared-memory table load and one dependent fma per bit-line sum, 64 per
// output and group, which no tensor core does.
// Ragged edges: rows past K in the last group are zero bits in both masks
// (the partial crossbar still converts every bit-line, as the reference
// pads); bits b >= k_i and c >= k_w enter the mma as zeros and are never
// converted; outputs past M or N are neither stored nor counted.  Op
// totals are int64, reduced per warp into one counter; the per-output
// counts (int32) are written only when asked for.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "trq.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kXbar = 128;                  // crossbar rows per group
constexpr int kMaxBits = 8;                 // k_i, k_w <= 8
constexpr int kWarps = 8;                   // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);  // + the producer warp
constexpr int kTN = 4 * kWarps;             // columns per block
constexpr int kStages = 4;                  // weight tiles in flight
// one weight plane of the tile; the 64 bytes of padding put planes c and
// c + 1 16 banks apart, so a warp's B fragment loads never conflict
constexpr int kPlane = kTN * 16 + 64;
constexpr int kStage = kMaxBits * kPlane;
constexpr int kTabRow = 256;                // table bytes per sum value
constexpr int kTabBytes = (kXbar + 1) * kTabRow;
constexpr int kMaxSplit = 8;                // portable cluster size
constexpr int kAccBudget = 32 * 1024;       // a split block's partials
constexpr unsigned kAll = 0xffffffffu;

template <int TM>
struct Layout {
  static constexpr int kOut = TM * kTN;                 // outputs per block
  static constexpr int kTab = 0;
  static constexpr int kStaging = kTab + kTabBytes;     // q, ops [129]
  static constexpr int kW = kStaging + 1040;
  static constexpr int kFull = kW + kStages * kStage;   // mbarriers
  static constexpr int kEmpty = kFull + kStages * 8;
  static constexpr int kOps = kEmpty + kStages * 8;     // int [kOut]
  static constexpr int kAcc = kOps + kOut * 4;          // float [slice][kOut]
  static constexpr int bytes(int slice) { return kAcc + slice * kOut * 4; }
};

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
// later async-proxy ones (the producer's next bulk copy into the stage).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Shared-memory loads and the chain's fma as volatile PTX: the compiler
// keeps volatile statements in program order, so every table load of a
// group is issued before the first fma of its dependent chain.
__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ int lds_s32(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ float fma_in_order(float q, float scale,
                                              float acc) {
  asm volatile("fma.rn.f32 %0, %1, %2, %0;" : "+f"(acc) : "f"(q), "f"(scale));
  return acc;
}
// D = popc(A & B) over one 128-row group: A 16 x 128 bits (row-major), B
// 128 x 8 bits (column-major), D 16 x 8 s32.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t b0) {
  d[0] = d[1] = d[2] = d[3] = 0;
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// One block: TM rows x 32 columns of the output, groups [rank*G/split,
// (rank+1)*G/split) where rank = blockIdx.z is the block's rank in its
// cluster of `split` blocks.  Grid: (M tiles, N tiles, split), the M tile
// fastest so the blocks that share a weight tile run together.  KI/KW are
// 8 in the full-width body and k_i/k_w in the general one.
template <int TM, bool kFull>
__global__ void __launch_bounds__(kThreads, 2)
xbar_mvm_tc(const uint32_t* __restrict__ a_mask,
            const unsigned char* __restrict__ w_mask,
            const float* __restrict__ scalars, float* __restrict__ out,
            int32_t* __restrict__ ops_out,
            unsigned long long* __restrict__ ops_total, int M, int G, int N,
            int k_i, int k_w, int n_r1, int n_r2, int m, int nu, int uniform,
            int lossless, int r_adc, int split) {
  using L = Layout<TM>;
  constexpr int kOut = L::kOut;
  constexpr int T = TM == 4 ? 2 : 4;        // m16 tiles: pairs of bits b
  constexpr int kConv = 2 * T * kMaxBits;   // sums a thread converts
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int KI = kFull ? kMaxBits : k_i, KW = kFull ? kMaxBits : k_w;
  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * kTN;
  const int rank = blockIdx.z;
  const int g_begin = rank * G / split, g_end = (rank + 1) * G / split;
  const int slice = g_end - g_begin;
  const int ncols = min(kTN, N - n0);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kFull);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + L::kEmpty);
  const bool consumer = warp < kWarps;

  // this thread's output (row ml, column nl of the tile) and its bits b
  const int ml = TM == 4 ? (gid & 3) : gid;
  const int b_base = TM == 4 ? 4 * (gid >> 2) : 0;
  const int nl = 4 * warp + tig;
  const int o = ml * kTN + nl;
  const bool valid = consumer && m0 + ml < M && nl < ncols;
  const bool owner = TM == 8 || gid >= 4;   // holds the finished sum

  auto issue = [&](int i) {  // group g_begin + i into stage i % kStages
    const int st = i % kStages;
    const int g = g_begin + i;
    mbar_expect_tx(full + st, KW * ncols * 16);
    for (int c = 0; c < KW; ++c)
      bulk_load(smem + L::kW + st * kStage + c * kPlane,
                w_mask + (((size_t)c * G + g) * N + n0) * 16, ncols * 16,
                full + st);
  };
  // word tig of row (b, m0 + ml) of group g: a_base + b * b_stride + 4 g
  const uint32_t* a_base = a_mask + ((size_t)(m0 + ml) * G) * 4 + tig;
  const int b_stride = M * G * 4;
  auto load_a = [&](int g, uint32_t (&a)[T][2]) {
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int b = b_base + 2 * t + r;
        a[t][r] = (b < KI && m0 + ml < M) ? __ldg(a_base + b * b_stride + 4 * g)
                                          : 0u;
      }
  };

  // -- the first loads in flight together: the weight tiles (the producer),
  // the registers and the first group's activation words ------------------
  if (warp == kWarps && lane == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < kStages && i < slice; ++i) issue(i);
  }
  const float delta_r1 = __ldg(scalars), bias = __ldg(scalars + 1);
  uint32_t a_cur[T][2] = {}, a_nxt[T][2] = {};
  if (consumer && slice > 0) load_a(g_begin, a_cur);

  // -- the quantizer table, one copy per lane ------------------------------
  float* stage_q = reinterpret_cast<float*>(smem + L::kStaging);
  int* stage_o = reinterpret_cast<int*>(smem + L::kStaging + 4 * (kXbar + 1));
  if (tid <= kXbar) {
    int ops;
    float q;
    if (lossless) {
      q = (float)tid;
      ops = r_adc;
    } else {
      const TrqRegs regs =
          trq_regs(delta_r1, bias, n_r1, n_r2, m, nu, uniform != 0);
      q = trq_unsigned((float)tid, regs, &ops);
    }
    stage_q[tid] = q;
    stage_o[tid] = ops;
  }
  __syncthreads();
  const bool table_ops =
      __syncthreads_or(tid <= kXbar && stage_o[tid] != stage_o[0]) != 0;
  const int const_ops = stage_o[0];
  // row p: q for lanes 0..31 (16 q for lanes 16..31 when TM = 4: they
  // convert b = 4..7), then ops for lanes 0..31; four copies a store
  for (int idx = tid; idx < (kXbar + 1) * 16; idx += kThreads) {
    const int p = idx >> 4, j = idx & 15;
    const float q =
        (TM == 4 && j >= 4) ? __fmul_rn(stage_q[p], 16.0f) : stage_q[p];
    const uint32_t v = j < 8 ? __float_as_uint(q) : (uint32_t)stage_o[p];
    reinterpret_cast<uint4*>(smem + L::kTab)[idx] = make_uint4(v, v, v, v);
  }
  __syncthreads();

  float acc = 0.0f;
  int ops_acc = 0;
  float* acc_buf = reinterpret_cast<float*>(smem + L::kAcc);
  if (!consumer) {
    // the producer: refill each stage once all consumer warps released it
    if (lane == 0)
      for (int i = kStages; i < slice; ++i) {
        mbar_wait(empty + i % kStages, (i / kStages - 1) & 1);
        issue(i);
      }
  } else {
    const uint32_t tab = smem_u32(smem + L::kTab) + 4 * lane;
    // bits this thread converts per group: its b range below k_i, x k_w
    const int n_on = max(0, min(2 * T, KI - b_base)) * KW;
    for (int i = 0; i < slice; ++i) {
      const int st = i % kStages;
      mbar_wait(full + st, (i / kStages) & 1);
      // B fragment j: column 4 warp + (gid >> 1), bit c = 2j + (gid & 1)
      const unsigned char* wt = smem + L::kW + st * kStage +
                                (4 * warp + (gid >> 1)) * 16 + tig * 4;
      uint32_t bw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 2 * j + (gid & 1);
        bw[j] = c < KW
                    ? *reinterpret_cast<const uint32_t*>(wt + c * kPlane)
                    : 0u;
      }
      // the refill of this stage is an async-proxy write: without a proxy
      // fence between the reads above and the release, it can land before
      // a lane's read (rarely, one weight word of one block:
      // tools/k3_stage_race.py reproduces it beside other work)
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
      int d[T][4][4];
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_and_popc(d[t][j], a_cur[t][0], a_cur[t][1], bw[j]);
      if (i + 1 < slice) load_a(g_begin + i + 1, a_nxt);

      // lookups in the conversion order: b = b_base + 2t + r, c = 2j + s;
      // d[t][j] = (b, c), (b, c + 1), (b + 1, c), (b + 1, c + 1)
      auto on = [&](int k) {
        return b_base + (k >> 3) < KI && (k & 7) < KW;
      };
      uint32_t addr[kConv];
#pragma unroll
      for (int k = 0; k < kConv; ++k) {
        const int t = k >> 4, r = (k >> 3) & 1, j = (k >> 1) & 3, s = k & 1;
        addr[k] = tab + d[t][j][2 * r + s] * kTabRow;
      }
      if (table_ops) {
        int oc[kConv];
#pragma unroll
        for (int k = 0; k < kConv; ++k)
          oc[k] = on(k) ? lds_s32(addr[k] + 128) : 0;
#pragma unroll
        for (int k = 0; k < kConv; ++k) ops_acc += oc[k];
      } else {
        ops_acc += n_on * const_ops;
      }
      float q[kConv];
#pragma unroll
      for (int k = 0; k < kConv; ++k) q[k] = on(k) ? lds_f32(addr[k]) : 0.0f;
      // the dependent chain, b outer and c inner (k ascending)
      auto chain = [&](float v) {
#pragma unroll
        for (int k = 0; k < kConv; ++k)
          if (on(k))  // fma of the exact product q * 2^(b+c)
            v = fma_in_order(q[k], (float)(1u << ((k >> 3) + (k & 7))), v);
        return v;
      };
      float v = chain(0.0f);
      if (TM == 4) v = chain(__shfl_xor_sync(kAll, v, 16));  // b = 4..7
      if (owner && valid) {
        if (split == 1)
          acc = __fadd_rn(acc, v);
        else
          acc_buf[i * kOut + o] = v;
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        a_cur[t][0] = a_nxt[t][0];
        a_cur[t][1] = a_nxt[t][1];
      }
    }
    // an output's ops: both halves of the pair when TM = 4
    if (TM == 4) ops_acc += __shfl_xor_sync(kAll, ops_acc, 16);
  }

  unsigned long long my_ops = 0;
  if (split == 1) {
    if (owner && valid) {
      const size_t at = (size_t)(m0 + ml) * N + n0 + nl;
      out[at] = acc;
      if (ops_out != nullptr) ops_out[at] = ops_acc;
      my_ops = (unsigned long long)ops_acc;
    }
  } else {
    // fold the tile's outputs over the cluster's groups in ascending order:
    // block `rank` takes outputs [rank*share, (rank+1)*share); it first
    // gathers their partials from every peer (independent remote loads, in
    // parallel) into its own table region, no longer needed, then folds
    int* ops_buf = reinterpret_cast<int*>(smem + L::kOps);
    if (owner && valid) ops_buf[o] = ops_acc;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int share = kOut / split;
    const int o0 = rank * share;
    float* gath = reinterpret_cast<float*>(smem + L::kTab);   // [G][share]
    int* ops_g = reinterpret_cast<int*>(smem + L::kStaging);  // [split][share]
    for (int idx = tid; idx < G * share; idx += kThreads) {
      const int g = idx / share, ol = idx - g * share;
      const int r = ((g + 1) * split - 1) / G;   // the rank that holds g
      gath[idx] = cluster.map_shared_rank(acc_buf, r)[(g - r * G / split) *
                                                          kOut + o0 + ol];
    }
    for (int idx = tid; idx < split * share; idx += kThreads)
      ops_g[idx] = cluster.map_shared_rank(ops_buf, idx / share)[o0 +
                                                                 idx % share];
    __syncthreads();
    const int of = o0 + tid, fml = of / kTN, fnl = of % kTN;
    if (tid < share && m0 + fml < M && fnl < ncols) {
      float v = 0.0f;
      int ov = 0;
      for (int g = 0; g < G; ++g) v = __fadd_rn(v, gath[g * share + tid]);
      for (int r = 0; r < split; ++r) ov += ops_g[r * share + tid];
      const size_t at = (size_t)(m0 + fml) * N + n0 + fnl;
      out[at] = v;
      if (ops_out != nullptr) ops_out[at] = ov;
      my_ops = (unsigned long long)ov;
    }
    cluster.sync();  // peers' shared memory stays alive until read
  }
  // op total: warp reduction, then one 64-bit atomic per warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    my_ops += __shfl_down_sync(kAll, my_ops, off);
  if (lane == 0 && my_ops) atomicAdd(ops_total, my_ops);
}

template <int TM, bool kFull>
int launch(const uint32_t* a, const unsigned char* w, const float* scalars,
           float* out, int32_t* ops_out, unsigned long long* ops_total, int M,
           int G, int N, int k_i, int k_w, int n_r1, int n_r2, int m, int nu,
           int uniform, int lossless, int r_adc, int split,
           cudaStream_t stream) {
  using L = Layout<TM>;
  auto kern = xbar_mvm_tc<TM, kFull>;
  // the attribute belongs to the current device: set it on every call (a
  // host-side store), so a launch on another device or thread finds it set
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::bytes(kAccBudget / (L::kOut * 4)));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int m_tiles = (M + TM - 1) / TM, n_tiles = (N + kTN - 1) / kTN;
  const int slice = split > 1 ? (G + split - 1) / split : 0;
  if (slice * L::kOut * 4 > kAccBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m_tiles, n_tiles, split);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L::bytes(slice);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, a, w, scalars, out, ops_out, ops_total, M, G, N, k_i, k_w,
      n_r1, n_r2, m, nu, uniform, lossless, r_adc, split));
}

}  // namespace

// a_mask: (k_i, M, G, 4) uint32 activation bit masks; w_mask: (k_w, G, N, 4)
// uint32 offset-encoded weight bit masks (bit r of word q <-> row
// g*128 + 32*q + r); both 16-byte aligned; scalars: [delta_r1, bias] f32
// on the device (unused when lossless); out: (M, N) f32, before the
// zero-point correction; ops_out: (M, N) int32 per-output counts, or null;
// ops_total: one int64 the caller zeroed.  tm (4 or 8 rows of M per block)
// and split (1, 2, 4 or 8 blocks per cluster) are the wrapper's shape plan
// (kernels/xbar_mvm/kernel.py::plan); the full-width body runs k_i = k_w =
// 8, the general one any other widths.  Returns the launch's CUDA error.
extern "C" int xbar_mvm_launch(const void* a_mask, const void* w_mask,
                               const float* scalars, float* out,
                               int32_t* ops_out,
                               unsigned long long* ops_total, int M, int G,
                               int N, int k_i, int k_w, int n_r1, int n_r2,
                               int m, int nu, int uniform, int lossless,
                               int r_adc, int tm, int split, void* stream) {
  if (k_i < 1 || k_i > kMaxBits || k_w < 1 || k_w > kMaxBits || M < 1 ||
      N < 1 || G < 0 || (long long)k_i * M * G * 4 >= (1LL << 31) ||
      (tm != 4 && tm != 8) ||
      (split != 1 && split != 2 && split != 4 && split != kMaxSplit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(a_mask);
  const unsigned char* w = static_cast<const unsigned char*>(w_mask);
  const bool full = k_i == kMaxBits && k_w == kMaxBits;
#define XBAR_LAUNCH(TM, FULL)                                                \
  launch<TM, FULL>(a, w, scalars, out, ops_out, ops_total, M, G, N, k_i, k_w, \
                   n_r1, n_r2, m, nu, uniform, lossless, r_adc, split, s)
  const int err = tm == 4 ? (full ? XBAR_LAUNCH(4, true) : XBAR_LAUNCH(4, false))
                          : (full ? XBAR_LAUNCH(8, true) : XBAR_LAUNCH(8, false));
#undef XBAR_LAUNCH
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
