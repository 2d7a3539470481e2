// K5: one whole FedAvg round in one launch.
//
// Replaces: benchmarks/mega_kernel_attempt.py::fused_round (its Pallas
// `kernel`), the whole-round mega-kernel that the JAX package keeps off its
// production path (as the port does: fedtpu_torch/benchmarks/
// mega_kernel_attempt.py drives it). Per client c:
//   1. forward of the client's model on its rows, and the masked CE loss
//      before the step, over denom = max(sum of the client's mask, 1);
//   2. backward: dz = (softmax * mask - onehot * mask) / denom at the
//      logits; per layer gW = a^T dz, gB = sum over rows of dz, and
//      dz <- (dz W^T) * (h > 0);
//   3. Adam on the client's own moments and count, as fedtpu_torch/ops/
//      optim.py computes it: StepLR from the count before the step, bias
//      corrections at count + 1; the count is written as count + 1;
//   4. the eval of the trained, not yet averaged model on the client's own
//      rows: first-max argmax, masked K x K confusion counts;
//   5. sum_c (w_c / max(sum w, 1e-30)) * trained_c, in client order as fp32
//      FMAs (K1's arithmetic), written into every client slot; when sum w is
//      0 every slot keeps its trained params, as the composed round does.
//
// Bound on the card: fp32 CUDA-core work on the real rows, about 88,000 flops
// a row at 14->50->200->2 (forward 22,452, backward ~43,500, eval 22,452):
// ~705 MFLOP at income-8's 8,000 rows, ~10.5 us at 67 TFLOP/s. It moves
// ~2.7 MB (params and moments in and out, x), ~0.8 us at 3.35 TB/s.
//
// Design. The TPU kernel walks the clients in order on one core, carries the
// average from one grid step to the next and keeps a client's whole shard in
// VMEM. Here blocks run in parallel, in no order, with 227 KB each, so:
// - Rows go in chunks: the wrapper's _fused_round_plan picks the largest row
//   chunk (64, 32, ...) whose layout below fits, and a work item is one
//   (chunk, client): at income-8, 128 items, one a block on 128 of the 132
//   SMs. (One thread-block cluster per client, with the gradient reduced in
//   distributed shared memory and no grid barrier, was measured slower: an
//   H100 runs only 7 clusters of 16 blocks, or 15 of 8, at once, so 8
//   clients get half the SMs the flat grid gets; PERF.md.)
// - One cooperative launch (every block resident: the grid is the wrapper's,
//   sized from the occupancy API) runs three phases with a grid-wide barrier
//   between them:
//   A. per work item: forward (every layer's output kept), loss partial,
//      backward; the chunk's gradient goes to its own slot of a
//      (chunks, C, D) scratch buffer;
//   B. per element of (C, D): the chunk partials summed in chunk order, then
//      Adam; per client: the loss partials summed in chunk order, count + 1;
//   C. per element of D: the weighted average into every slot; then per work
//      item: the eval of the trained params, counts in shared memory, one
//      global atomicAdd per cell.
// - A block stages a client's parameters (phase A) and trained parameters
//   (phase C) with one bulk asynchronous copy on an mbarrier (45 KB at
//   income-8) while its threads load the chunk's rows, in place of a copy by
//   plain loads.
// - The tiles are bound by shared-memory loads, not FMAs (an SM issues
//   fewer than one 32-bit shared load a clock and ~120 FMAs), so the operand
//   a thread shares with its warp comes four values at a time in 128-bit
//   broadcast loads: the activations are kept feature-major, so the forward
//   loads 4 rows of an input feature at once (16 x 4 tiles) and the weight
//   gradient 4 rows of an activation; the input gradient loads 4 weights of
//   a row at once where the rows are 16-byte aligned. The backward uses the
//   largest of 8 x 4, 4 x 4, 2 x 2 register tiles that still gives
//   FT_ROUND_MIN_TILES threads work (ft_round_tile; 8 x 8 spills at 512
//   threads' 128 registers). A tile changes the schedule only: each output
//   is one sequential fp32 FMA chain, and the eval's forward is K3's order,
//   so K2, K3 and K5 give the same logits for the same params. A layer's
//   weight gradient and its input gradient run back to back without a
//   barrier between them (separate dz buffers).
// - No float atomics in any sum: every sum has a fixed order, so two
//   launches on the same inputs give the same bits. The count atomics add
//   0/1 masks below 2^24, exact in any order.
// - fp32 on the CUDA cores, expf/logf, no fast math: the eval's argmaxes and
//   Adam's first step (which sends every gradient to +-lr whatever its size)
//   are the reasons not to take TF32.
//
// Shared memory (floats), R rows a chunk: the staging layout of
// mlp_forward.cuh (a 4-float header holding the mbarrier, the parameters
// with alignment slack); the x tile and each layer's output feature-major
// (a row of ldr = ft_round_ldr(R) floats per feature: dims[0] + the sum of
// the layer widths rows of them); two dz buffers of R x the widest odd
// stride; the tile's mask and labels (R each); 32 floats of reduction
// scratch; K x K counts. ft_fused_round refuses a byte count that does not
// hold it.
#include <cooperative_groups.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "mlp_forward.cuh"

namespace cg = cooperative_groups;

#define FT_ROUND_THREADS 512
#define FT_ROUND_MAX_ROWS 64
#define FT_ROUND_MIN_TILES 192
#define FT_ROUND_STAMPS 8

struct FtRound {
  const float* params;  // (C, D)
  const float* mu;
  const float* nu;
  const int* count;     // (C,)
  const float* x;       // (C, n, dims[0])
  const int* y;         // (C, n)
  const float* mask;    // (C, n)
  const float* weights; // (C,)
  float* grad_part;     // scratch (chunks, C, D)
  float* loss_part;     // scratch (chunks, C)
  float* denom;         // scratch (C,)
  float* trained;       // scratch (C, D)
  float* params_out;    // (C, D)
  float* mu_out;
  float* nu_out;
  int* count_out;       // (C,)
  float* loss;          // (C,)
  float* conf;          // (C, K, K)
  long long* phase_ns;  // null, or (blocks, FT_ROUND_STAMPS) stamps
  int clients, n, num_params, rows_per, chunks, ldmax;
  int ldr;  // stride of the feature-major x tile and layer outputs
  float lr0, gamma, step_size, b1, one_minus_b1, b2, one_minus_b2, eps;
  MlpDims md;
  int offs[FT_MAX_LAYERS];      // each layer's first parameter
  int act_offs[FT_MAX_LAYERS];  // each layer's output tile, after the x tile
};

// %globaltimer (ns) into this block's stamp `slot`, when stamps are asked
// for: phase i of the round runs from stamp 2i to stamp 2i + 1.
__device__ __forceinline__ void ft_stamp(long long* ns, int slot) {
  if (ns && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    ns[(size_t)blockIdx.x * FT_ROUND_STAMPS + slot] = t;
  }
}

// Sum of one value per thread in a fixed order: a butterfly within each warp
// (every lane ends with the same bits), then the warps' sums in warp order.
// Every thread returns the same value, launch after launch. `red` holds 32
// floats; the call is a block-wide barrier.
__device__ __forceinline__ float ft_block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // a previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += red[i];
  return s;
}

// The register tile of an m x n output: the largest of 16 x 4 (the forward
// only), 8 x 4, 4 x 4 and 2 x 2 with at least FT_ROUND_MIN_TILES tiles,
// else 1 x 1 (as 10 * TM + TN).
__device__ __forceinline__ int ft_round_tile(int m, int n, bool sixteen) {
  if (sixteen && ((m + 15) / 16) * ((n + 3) / 4) >= FT_ROUND_MIN_TILES)
    return 164;
  if (((m + 7) / 8) * ((n + 3) / 4) >= FT_ROUND_MIN_TILES) return 84;
  if (((m + 3) / 4) * ((n + 3) / 4) >= FT_ROUND_MIN_TILES) return 44;
  if (((m + 1) / 2) * ((n + 1) / 2) >= FT_ROUND_MIN_TILES) return 22;
  return 11;
}

#define FT_ROUND_DISPATCH(tile, F, ...)  \
  switch (tile) {                        \
    case 84: F<8, 4>(__VA_ARGS__); break; \
    case 44: F<4, 4>(__VA_ARGS__); break; \
    case 22: F<2, 2>(__VA_ARGS__); break; \
    default: F<1, 1>(__VA_ARGS__);        \
  }

// g[a][b] = sum over r < rows of act[a][r] * dz[r][b] (in x out, row-major,
// global memory; act feature-major with stride lda, a multiple of 4). Each
// thread owns TA neighbouring a's (shared with the warp: four rows of each
// come in one 128-bit load) and TB b's interleaved across the warp
// (neighbouring dz addresses in shared memory, coalesced writes). Each entry
// is one FMA chain over r in order.
template <int TA, int TB>
__device__ __forceinline__ void ft_grad_w_tiled(const float* act, int lda,
                                                const float* dz, int ldz,
                                                int rows, int in, int out,
                                                float* __restrict__ g) {
  const int agroups = (in + TA - 1) / TA;
  const int bgroups = (out + TB - 1) / TB;
  const int rows4 = rows & ~3;
  for (int t = threadIdx.x; t < agroups * bgroups; t += blockDim.x) {
    const int at = t / bgroups;
    const int bt = t - at * bgroups;
    int a[TA], b[TB];
#pragma unroll
    for (int i = 0; i < TA; ++i) a[i] = min(at * TA + i, in - 1);
#pragma unroll
    for (int q = 0; q < TB; ++q) b[q] = min(bt + q * bgroups, out - 1);
    float acc[TA][TB];
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int q = 0; q < TB; ++q) acc[i][q] = 0.f;
    for (int r = 0; r < rows4; r += 4) {
      float4 av[TA];
#pragma unroll
      for (int i = 0; i < TA; ++i)
        av[i] = *reinterpret_cast<const float4*>(act + a[i] * lda + r);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float dv[TB];
#pragma unroll
        for (int q = 0; q < TB; ++q) dv[q] = dz[(r + u) * ldz + b[q]];
#pragma unroll
        for (int i = 0; i < TA; ++i) {
          const float ai = u == 0 ? av[i].x : u == 1 ? av[i].y
                         : u == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int q = 0; q < TB; ++q) acc[i][q] = fmaf(ai, dv[q], acc[i][q]);
        }
      }
    }
    for (int r = rows4; r < rows; ++r) {
#pragma unroll
      for (int i = 0; i < TA; ++i) {
        const float ai = act[a[i] * lda + r];
#pragma unroll
        for (int q = 0; q < TB; ++q)
          acc[i][q] = fmaf(ai, dz[r * ldz + b[q]], acc[i][q]);
      }
    }
#pragma unroll
    for (int i = 0; i < TA; ++i) {
      if (at * TA + i >= in) continue;
#pragma unroll
      for (int q = 0; q < TB; ++q)
        if (bt + q * bgroups < out) g[(size_t)a[i] * out + b[q]] = acc[i][q];
    }
  }
}

// dzn[r][a] = (sum over b of dz[r][b] * w[a][b]) * (act[a][r] > 0), for
// r < rows and a < in (w is the layer's (in, out) weight, act its input,
// feature-major with stride lda). Each thread owns TR rows interleaved
// across the warp (odd strides: no bank conflicts) x TJ neighbouring a's
// (weight loads shared with the warp). When out is a multiple of 4 the
// weights come four b's at a time in 128-bit loads, from the first b where
// w's rows are 16-byte aligned; each entry is one FMA chain over b in
// order either way.
template <int TR, int TJ>
__device__ __forceinline__ void ft_grad_h_tiled(const float* dz, int ldz,
                                                const float* w, int in,
                                                int out, const float* act,
                                                int lda, int rows, float* dzn,
                                                int ldn) {
  const int rgroups = (rows + TR - 1) / TR;
  const int jgroups = (in + TJ - 1) / TJ;
  // b's before w's rows reach a 16-byte boundary, and the end of the
  // 4-aligned run (no run when out is not a multiple of 4).
  const int head = (out & 3) ? out
                             : (int)((16 - ((uintptr_t)w & 15)) & 15) / 4;
  const int end4 = (out & 3) ? out : head + ((out - head) & ~3);
  for (int t = threadIdx.x; t < rgroups * jgroups; t += blockDim.x) {
    const int jt = t / rgroups;
    const int rt = t - jt * rgroups;
    int r[TR], a[TJ];
#pragma unroll
    for (int i = 0; i < TR; ++i) r[i] = min(rt + i * rgroups, rows - 1);
#pragma unroll
    for (int q = 0; q < TJ; ++q) a[q] = min(jt * TJ + q, in - 1);
    float acc[TR][TJ];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int q = 0; q < TJ; ++q) acc[i][q] = 0.f;
    // b's before the aligned run, the run 4 at a time, the b's after it:
    // every entry's chain over b in order.
    for (int b = 0; b < out; ++b) {
      if (b == head && head < end4) {
        for (; b < end4; b += 4) {
          float4 w4[TJ];
#pragma unroll
          for (int q = 0; q < TJ; ++q)
            w4[q] = *reinterpret_cast<const float4*>(w + a[q] * out + b);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float dv[TR];
#pragma unroll
            for (int i = 0; i < TR; ++i) dv[i] = dz[r[i] * ldz + b + u];
#pragma unroll
            for (int q = 0; q < TJ; ++q) {
              const float wq = u == 0 ? w4[q].x : u == 1 ? w4[q].y
                             : u == 2 ? w4[q].z : w4[q].w;
#pragma unroll
              for (int i = 0; i < TR; ++i)
                acc[i][q] = fmaf(dv[i], wq, acc[i][q]);
            }
          }
        }
        if (b >= out) break;
      }
      float dv[TR], wv[TJ];
#pragma unroll
      for (int i = 0; i < TR; ++i) dv[i] = dz[r[i] * ldz + b];
#pragma unroll
      for (int q = 0; q < TJ; ++q) wv[q] = w[a[q] * out + b];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int q = 0; q < TJ; ++q) acc[i][q] = fmaf(dv[i], wv[q], acc[i][q]);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if (rt + i * rgroups >= rows) continue;
#pragma unroll
      for (int q = 0; q < TJ; ++q) {
        if (jt * TJ + q >= in) continue;
        const float live = act[a[q] * lda + r[i]] > 0.f ? 1.f : 0.f;
        dzn[r[i] * ldn + a[q]] = acc[i][q] * live;
      }
    }
  }
}

// One layer of the forward over feature-major activations: oT[j][r] =
// relu(sum over i of hT[i][r] * w[i][j], a chain over i from 0, then + b),
// K3's FMA order, so the same bits as K2's and K3's forward. Each thread
// owns TM neighbouring rows (shared with the warp, loaded 4 at a time: one
// 128-bit load where TM is a multiple of 4) x TN outputs interleaved across
// the warp. ld is a multiple of 4 and at least the rows rounded up to 16,
// so the vector loads stay in the tile (rows past `rows` are computed and
// dropped).
template <int TM, int TN>
__device__ __forceinline__ void ft_round_fwd_tiled(const float* hT, int ld,
                                                   int in, const float* w,
                                                   const float* b, int out,
                                                   bool relu, int rows,
                                                   float* oT) {
  const int rgroups = (rows + TM - 1) / TM;
  const int jgroups = (out + TN - 1) / TN;
  for (int t = threadIdx.x; t < rgroups * jgroups; t += blockDim.x) {
    const int rt = t / jgroups;
    const int jt = t - rt * jgroups;
    const int r0 = rt * TM;
    int j[TN];
#pragma unroll
    for (int q = 0; q < TN; ++q) j[q] = min(jt + q * jgroups, out - 1);
    float acc[TM][TN];
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int q = 0; q < TN; ++q) acc[a][q] = 0.f;
    // Small tiles are latency chains (the 200 -> 2 layer: one output a
    // thread): unroll deep, so loads run ahead of the FMAs.
    constexpr int kUnroll = TM * TN >= 32 ? 2 : 8;
#pragma unroll kUnroll
    for (int i = 0; i < in; ++i) {
      float hv[TM], wv[TN];
      const float* h = hT + i * ld + r0;
      if (TM % 4 == 0) {
#pragma unroll
        for (int u = 0; u < TM / 4; ++u) {
          const float4 v = reinterpret_cast<const float4*>(h)[u];
          hv[4 * u] = v.x;
          hv[4 * u + 1] = v.y;
          hv[4 * u + 2] = v.z;
          hv[4 * u + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int a = 0; a < TM; ++a) hv[a] = h[a];
      }
#pragma unroll
      for (int q = 0; q < TN; ++q) wv[q] = w[i * out + j[q]];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[a][q] = fmaf(hv[a], wv[q], acc[a][q]);
    }
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      if (jt + q * jgroups >= out) continue;
      const float bj = b[j[q]];
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        const float v = acc[a][q] + bj;
        acc[a][q] = (relu && v < 0.f) ? 0.f : v;
      }
      float* o = oT + j[q] * ld + r0;
      if (TM % 4 == 0 && r0 + TM <= rows) {
#pragma unroll
        for (int u = 0; u < TM / 4; ++u)
          reinterpret_cast<float4*>(o)[u] =
              make_float4(acc[4 * u][q], acc[4 * u + 1][q],
                          acc[4 * u + 2][q], acc[4 * u + 3][q]);
      } else {
#pragma unroll
        for (int a = 0; a < TM; ++a)
          if (r0 + a < rows) o[a] = acc[a][q];
      }
    }
  }
}

// The forward of `rows` rows of xT through the model at p, every layer's
// output kept feature-major in act[l] (stride ld); visible to the block on
// return.
__device__ __forceinline__ void ft_round_forward(const FtRound& a,
                                                 const float* p,
                                                 const float* xT, int rows,
                                                 float* acts) {
  const MlpDims& md = a.md;
  const float* cur = xT;
  for (int l = 0; l < md.n_layers; ++l) {
    const int in = md.dims[l];
    const int out = md.dims[l + 1];
    const float* w = p + a.offs[l];
    float* o = acts + a.act_offs[l];
    const int tile = ft_round_tile(rows, out, true);
    if (tile == 164)
      ft_round_fwd_tiled<16, 4>(cur, a.ldr, in, w, w + in * out, out,
                                l < md.n_layers - 1, rows, o);
    else
      FT_ROUND_DISPATCH(tile, ft_round_fwd_tiled, cur, a.ldr, in, w,
                        w + in * out, out, l < md.n_layers - 1, rows, o)
    __syncthreads();
    cur = o;
  }
}

// Issues the bulk copy of one client's `count` parameters at src into the
// staging buffer (mlp_forward.cuh's layout, after the mbarrier header) and
// returns where they will lie; the block then waits with
// ft_round_stage_wait.
__device__ __forceinline__ const float* ft_round_stage(float* smem,
                                                       const float* src,
                                                       int count) {
  ft_chunk_issue(reinterpret_cast<uint64_t*>(smem), smem + 4, src, count);
  return ft_chunk_at(smem + 4, src);
}

// Waits for the staging numbered `uses` (from 0) on the mbarrier, after a
// __syncthreads() that publishes the parts copied with plain loads.
__device__ __forceinline__ void ft_round_stage_wait(float* smem, int uses) {
  __syncthreads();
  ft_bar_wait(reinterpret_cast<uint64_t*>(smem), uses & 1);
}

// Loads one chunk's x tile (feature-major, stride ldr), mask and labels
// with plain loads.
__device__ __forceinline__ void ft_round_load_rows(const FtRound& a,
                                                   size_t g0, int rows,
                                                   float* xT, float* rowm,
                                                   int* rowy) {
  const int din = a.md.dims[0];
  for (int i = threadIdx.x; i < rows * din; i += blockDim.x) {
    const int r = i / din;
    xT[(i - r * din) * a.ldr + r] = a.x[g0 * din + i];
  }
  if (threadIdx.x < rows) {
    rowm[threadIdx.x] = a.mask[g0 + threadIdx.x];
    rowy[threadIdx.x] = a.y[g0 + threadIdx.x];
  }
}

__global__ void __launch_bounds__(FT_ROUND_THREADS, 1)
ft_fused_round_kernel(const FtRound a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const MlpDims& md = a.md;
  const int nl = md.n_layers;
  const int din = md.dims[0];
  const int k = md.dims[nl];
  const int rp = a.rows_per;
  const int C = a.clients;
  const int D = a.num_params;
  const int tid = threadIdx.x;
  const long long gtid = (long long)blockIdx.x * blockDim.x + tid;
  const long long gthreads = (long long)gridDim.x * blockDim.x;
  const int items = a.chunks * C;

  // The layout of the header comment, in its order.
  const int ldr = a.ldr;
  float* xt = smem + ft_stage_floats(D);
  float* acts = xt + din * ldr;  // layer l's output at acts + act_offs[l]
  float* dz0 = acts + a.act_offs[nl - 1] + md.dims[nl] * ldr;
  float* dz1 = dz0 + rp * a.ldmax;
  float* rowm = dz1 + rp * a.ldmax;
  int* rowy = reinterpret_cast<int*>(rowm + rp);
  float* red = rowm + 2 * rp;
  float* counts = red + 32;
  const int ldk = ft_act_stride(k);

  ft_stamp(a.phase_ns, 0);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     ft_smem_addr(smem))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The confusion counts are added to in phase C only.
  for (long long i = gtid; i < (long long)C * k * k; i += gthreads)
    a.conf[i] = 0.f;
  __syncthreads();  // the mbarrier's init comes before any use of it

  // ---- Phase A: per (chunk, client): forward, loss partial, backward.
  int uses = 0;  // stagings on the mbarrier so far
  int staged = -1, denom_client = -1;
  float denom = 1.f;
  const float* p = nullptr;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c = item / a.chunks;
    const int kc = item - c * a.chunks;
    const int row0 = kc * rp;
    const int rows = min(rp, a.n - row0);
    const size_t g0 = (size_t)c * a.n + row0;  // the chunk's first row
    if (c != denom_client) {
      float s = 0.f;
      for (int i = tid; i < a.n; i += blockDim.x)
        s += a.mask[(size_t)c * a.n + i];
      denom = fmaxf(ft_block_sum(s, red), 1.f);
      denom_client = c;
    }
    if (kc == 0 && tid == 0) a.denom[c] = denom;
    float* gp = a.grad_part + ((size_t)kc * C + c) * D;
    if (!__syncthreads_or(tid < rows && a.mask[g0 + tid] != 0.f)) {
      // All padding: no loss and no gradient.
      for (int i = tid; i < D; i += blockDim.x) gp[i] = 0.f;
      if (tid == 0) a.loss_part[(size_t)kc * C + c] = 0.f;
      continue;
    }
    const bool stage = c != staged;
    if (stage) p = ft_round_stage(smem, a.params + (size_t)c * D, D);
    ft_round_load_rows(a, g0, rows, xt, rowm, rowy);
    if (stage) {
      ft_round_stage_wait(smem, uses++);
      staged = c;
    }
    __syncthreads();

    // 1. Forward, keeping every layer's output (K3's FMA order).
    ft_round_forward(a, p, xt, rows, acts);

    // 2. Log-softmax, the loss partial and dz at the logits, a row a thread.
    float ll_m = 0.f;
    if (tid < rows) {
      const float* z = acts + a.act_offs[nl - 1] + tid;  // z[j * ldr]
      float zmax = z[0];
      for (int j = 1; j < k; ++j) zmax = fmaxf(zmax, z[j * ldr]);
      float se = 0.f;
      for (int j = 0; j < k; ++j) se += expf(z[j * ldr] - zmax);
      const float lse = logf(se);
      const int label = rowy[tid];
      const float m = rowm[tid];
      float ll = 0.f;
      for (int j = 0; j < k; ++j) {
        const float lp = (z[j * ldr] - zmax) - lse;
        const float oh = j == label ? 1.f : 0.f;
        ll += lp * oh;
        dz0[tid * ldk + j] = (expf(lp) * m - oh * m) / denom;
      }
      ll_m = ll * m;
    }
    const float part = ft_block_sum(ll_m, red);  // also publishes dz0
    if (tid == 0) a.loss_part[(size_t)kc * C + c] = part;

    // 3. Backward, last layer first; the chunk's gradient goes to gp. A
    //    layer's weight and input gradients run back to back.
    float* dz = dz0;
    float* dzn = dz1;
    int ldz = ldk;
    for (int l = nl - 1; l >= 0; --l) {
      const int in = md.dims[l];
      const int out = md.dims[l + 1];
      const float* ain = l == 0 ? xt : acts + a.act_offs[l - 1];
      float* gl = gp + a.offs[l];
      FT_ROUND_DISPATCH(ft_round_tile(in, out, false), ft_grad_w_tiled, ain,
                        ldr, dz, ldz, rows, in, out, gl)
      for (int j = tid; j < out; j += blockDim.x) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += dz[r * ldz + j];
        gl[in * out + j] = s;
      }
      if (l > 0) {
        FT_ROUND_DISPATCH(ft_round_tile(rows, in, false), ft_grad_h_tiled, dz,
                          ldz, p + a.offs[l], in, out, ain, ldr, rows, dzn,
                          ft_act_stride(in))
        __syncthreads();
        float* t = dz;
        dz = dzn;
        dzn = t;
        ldz = ft_act_stride(in);
      }
    }
    __syncthreads();  // the tile's buffers are free for the next item
  }
  ft_stamp(a.phase_ns, 1);
  grid.sync();
  ft_stamp(a.phase_ns, 2);

  // ---- Phase B: per element of (C, D), the gradient in chunk order, Adam.
  const size_t cd = (size_t)C * D;
  for (size_t e = gtid; e < cd; e += gthreads) {
    const int c = (int)(e / D);
    float g = 0.f;
    for (int kc = 0; kc < a.chunks; ++kc)
      g += __ldcg(a.grad_part + (size_t)kc * cd + e);
    const int cnt = a.count[c];
    const float lr =
        a.lr0 * powf(a.gamma, floorf((float)cnt / a.step_size));
    const float t = (float)(cnt + 1);
    const float bc1 = 1.f - powf(a.b1, t);
    const float bc2 = 1.f - powf(a.b2, t);
    const float m2 = a.one_minus_b1 * g + a.b1 * a.mu[e];
    const float v2 = a.one_minus_b2 * (g * g) + a.b2 * a.nu[e];
    const float upd = (m2 / bc1) / (sqrtf(v2 / bc2) + a.eps);
    a.trained[e] = a.params[e] + (-lr) * upd;
    a.mu_out[e] = m2;
    a.nu_out[e] = v2;
  }
  for (long long c = gtid; c < C; c += gthreads) {
    float s = 0.f;
    for (int kc = 0; kc < a.chunks; ++kc)
      s += __ldcg(a.loss_part + (size_t)kc * C + c);
    a.loss[c] = -s / __ldcg(a.denom + c);
    a.count_out[c] = a.count[c] + 1;
  }
  ft_stamp(a.phase_ns, 3);
  grid.sync();
  ft_stamp(a.phase_ns, 4);

  // ---- Phase C: the weighted average into every slot (K1's arithmetic) ...
  float total = 0.f;
  for (int c = 0; c < C; ++c) total += a.weights[c];
  const float tot = fmaxf(total, 1e-30f);
  for (long long d = gtid; d < D; d += gthreads) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c)
      acc = fmaf(a.weights[c] / tot, __ldcg(a.trained + (size_t)c * D + d),
                 acc);
    for (int c = 0; c < C; ++c)
      a.params_out[(size_t)c * D + d] =
          total > 0.f ? acc : __ldcg(a.trained + (size_t)c * D + d);
  }
  // ... and per (chunk, client) the eval of the trained params. Other blocks
  // wrote them before the barrier, through the generic proxy; the bulk copy
  // reads them through the async proxy.
  if (tid == 0) asm volatile("fence.proxy.async.global;\n" ::: "memory");
  staged = -1;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c = item / a.chunks;
    const int kc = item - c * a.chunks;
    const int row0 = kc * rp;
    const int rows = min(rp, a.n - row0);
    const size_t g0 = (size_t)c * a.n + row0;
    if (!__syncthreads_or(tid < rows && a.mask[g0 + tid] != 0.f)) continue;
    const bool stage = c != staged;
    if (stage) p = ft_round_stage(smem, a.trained + (size_t)c * D, D);
    ft_round_load_rows(a, g0, rows, xt, rowm, rowy);
    for (int i = tid; i < k * k; i += blockDim.x) counts[i] = 0.f;
    if (stage) {
      ft_round_stage_wait(smem, uses++);
      staged = c;
    }
    __syncthreads();
    ft_round_forward(a, p, xt, rows, acts);
    if (tid < rows) {
      const float* h = acts + a.act_offs[nl - 1] + tid;  // h[j * ldr]
      float best = h[0];
      int pred = 0;
      for (int j = 1; j < k; ++j) {
        const float v = h[j * ldr];
        if (!isnan(best) && (isnan(v) || v > best)) {
          best = v;
          pred = j;
        }
      }
      const int label = rowy[tid];
      const float mk = rowm[tid];
      if (mk != 0.f && label >= 0 && label < k)
        atomicAdd(&counts[label * k + pred], mk);
    }
    __syncthreads();
    for (int i = tid; i < k * k; i += blockDim.x)
      if (counts[i] != 0.f)
        atomicAdd(&a.conf[(size_t)c * k * k + i], counts[i]);
    __syncthreads();
  }
  ft_stamp(a.phase_ns, 5);
}

// The most blocks of the kernel that can be resident at once on `dev` with
// `smem_bytes` of shared memory each: a grid barrier needs every block
// resident. The loop that launches K5 is host-bound, so the attribute and
// occupancy queries run once per (device, bytes) and their answer is kept.
// The shared-memory attribute only grows, so every answer kept stays valid.
// The stride of the feature-major x tile and layer outputs at R rows a
// chunk: a multiple of 4 (128-bit loads) past R rounded up to 16 (a 16-row
// tile's loads stay in the buffer), and not a multiple of 32 (the 128-bit
// stores of neighbouring features fall in different banks).
static int ft_round_ldr(int rows) { return (rows + 15) / 16 * 16 + 4; }

static cudaError_t ft_round_resident_blocks(int dev, int smem_bytes,
                                            int* blocks) {
  static std::mutex lock;
  static std::map<std::pair<int, int>, int> known;
  static std::map<int, int> smem_allowed;
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = known.find({dev, smem_bytes});
  if (hit != known.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (smem_bytes > smem_allowed[dev]) {
    err = cudaFuncSetAttribute(ft_fused_round_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return err;
    smem_allowed[dev] = smem_bytes;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ft_fused_round_kernel, FT_ROUND_THREADS, smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = known[{dev, smem_bytes}] = per_sm * sms;
  return cudaSuccess;
}

// *blocks: how many blocks of `smem_bytes` can be resident at once on the
// current device (the wrapper's plan sizes the grid from it). Returns a
// cudaError_t.
extern "C" int ft_fused_round_resident(int smem_bytes, int* blocks) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)ft_round_resident_blocks(dev, smem_bytes, blocks);
}

// params, mu, nu (C, D); count (C,) int32; x (C, n, dims[0]); y (C, n) int32;
// mask (C, n); weights (C,); dims a host array of n_layers + 1; adam a host
// array {lr0, gamma, step_size, b1, 1 - b1, b2, 1 - b2, eps}. rows_per_chunk,
// smem_bytes and blocks are the wrapper's plan (_fused_round_plan); a byte
// count that does not hold the layout above, or more blocks than can be
// resident, is refused. scratch holds chunks * C * D + chunks * C + C + C * D
// floats. Outputs: params_out, mu_out, nu_out (C, D), count_out (C,) int32,
// loss (C,), conf (C, K, K); phase_ns null or (blocks, FT_ROUND_STAMPS)
// int64. One cooperative launch; returns its cudaError_t.
extern "C" int ft_fused_round(const float* params, const float* mu,
                              const float* nu, const int* count,
                              const float* x, const int* y, const float* mask,
                              const float* weights, int clients, int n,
                              const int* dims, int n_layers, const float* adam,
                              int rows_per_chunk, int smem_bytes, int blocks,
                              float* scratch, float* params_out, float* mu_out,
                              float* nu_out, int* count_out, float* loss,
                              float* conf, long long* phase_ns, void* stream) {
  if (clients < 1 || n < 1 || n_layers < 1 || n_layers > FT_MAX_LAYERS ||
      rows_per_chunk < 1 || rows_per_chunk > FT_ROUND_MAX_ROWS || blocks < 1)
    return (int)cudaErrorInvalidValue;
  FtRound a;
  int widest;
  a.md = ft_make_dims(dims, n_layers, &widest);
  const int ldr = ft_round_ldr(rows_per_chunk);
  int off = 0, feats = dims[0], ldmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    a.offs[l] = off;
    a.act_offs[l] = (feats - dims[0]) * ldr;
    off += dims[l] * dims[l + 1] + dims[l + 1];
    feats += dims[l + 1];
    ldmax = std::max(ldmax, ft_act_stride(dims[l + 1]));
  }
  const int k = dims[n_layers];
  const size_t need =
      sizeof(float) *
      ((size_t)ft_stage_floats(off) + (size_t)feats * ldr +
       (size_t)rows_per_chunk * (2 * ldmax + 2) + 32 + (size_t)k * k);
  if (smem_bytes < 0 || need > (size_t)smem_bytes)
    return (int)cudaErrorInvalidValue;
  int dev, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = ft_round_resident_blocks(dev, smem_bytes, &resident);
  if (err != cudaSuccess) return (int)err;
  if (blocks > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int chunks = (n + rows_per_chunk - 1) / rows_per_chunk;
  const size_t cd = (size_t)clients * off;
  a.params = params;
  a.mu = mu;
  a.nu = nu;
  a.count = count;
  a.x = x;
  a.y = y;
  a.mask = mask;
  a.weights = weights;
  a.grad_part = scratch;
  a.loss_part = a.grad_part + (size_t)chunks * cd;
  a.denom = a.loss_part + (size_t)chunks * clients;
  a.trained = a.denom + clients;
  a.params_out = params_out;
  a.mu_out = mu_out;
  a.nu_out = nu_out;
  a.count_out = count_out;
  a.loss = loss;
  a.conf = conf;
  a.phase_ns = phase_ns;
  a.clients = clients;
  a.n = n;
  a.num_params = off;
  a.rows_per = rows_per_chunk;
  a.chunks = chunks;
  a.ldmax = ldmax;
  a.ldr = ldr;
  a.lr0 = adam[0];
  a.gamma = adam[1];
  a.step_size = adam[2];
  a.b1 = adam[3];
  a.one_minus_b1 = adam[4];
  a.b2 = adam[5];
  a.one_minus_b2 = adam[6];
  a.eps = adam[7];
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)ft_fused_round_kernel,
                                    dim3(blocks), dim3(FT_ROUND_THREADS), args,
                                    (size_t)smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
