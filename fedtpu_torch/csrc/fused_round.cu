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
//   (chunk, client). A block keeps its client's parameters in shared memory
//   across items of the same client.
// - One cooperative launch (every block resident: the grid is sized with the
//   occupancy API) runs three phases with a grid-wide barrier between them:
//   A. per work item: forward (every layer's output kept), loss partial,
//      backward; the chunk's gradient goes to its own slot of a
//      (chunks, C, D) scratch buffer;
//   B. per element of (C, D): the chunk partials summed in chunk order, then
//      Adam; per client: the loss partials summed in chunk order, count + 1;
//   C. per element of D: the weighted average into every slot; then per work
//      item: the eval of the trained params through K2's register-tiled
//      forward (K3's FMA order, so K2 and K3 give the same logits for the
//      same params), counts in shared memory, one global atomicAdd per cell.
// - No float atomics in any sum: every sum has a fixed order, so two
//   launches on the same inputs give the same bits. The count atomics add
//   0/1 masks below 2^24, exact in any order.
// - fp32 on the CUDA cores, expf/logf, no fast math: the eval's argmaxes and
//   Adam's first step (which sends every gradient to +-lr whatever its size)
//   are the reasons not to take TF32.
//
// Shared memory (floats), R rows a chunk: the parameters rounded up to 4; the
// x tile, R x dims[0]; each layer's output, R x ft_act_stride(out); two dz
// buffers of R x the widest odd stride; the tile's mask and labels (R each);
// 32 floats of reduction scratch; K x K counts. ft_fused_round refuses a
// byte count that does not hold it.
#include <cooperative_groups.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "mlp_forward.cuh"

namespace cg = cooperative_groups;

#define FT_ROUND_THREADS 512
#define FT_ROUND_MAX_ROWS 64

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
  int clients, n, num_params, rows_per, chunks, ldmax;
  float lr0, gamma, step_size, b1, one_minus_b1, b2, one_minus_b2, eps;
  MlpDims md;
  int offs[FT_MAX_LAYERS];  // each layer's first parameter
};

// Block-cooperative copy into shared memory of data that other blocks wrote
// earlier in this launch: loads through L2 (ld.global.cg), never through the
// non-coherent read-only path.
__device__ __forceinline__ void ft_copy_from_l2(float* dst, const float* src,
                                                int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    dst[i] = __ldcg(src + i);
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

// g[a][b] = sum over r < rows of act[r][a] * dz[r][b] (in x out, row-major,
// global memory). Each thread owns TA x TB outputs: TA neighbouring a's (its
// act loads are shared with the warp) and TB b's interleaved across the warp
// (neighbouring dz addresses in shared memory, coalesced writes).
template <int TA, int TB>
__device__ __forceinline__ void ft_grad_w_tiled(const float* act, int lda,
                                                const float* dz, int ldz,
                                                int rows, int in, int out,
                                                float* __restrict__ g) {
  const int agroups = (in + TA - 1) / TA;
  const int bgroups = (out + TB - 1) / TB;
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
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      float av[TA], dv[TB];
#pragma unroll
      for (int i = 0; i < TA; ++i) av[i] = act[r * lda + a[i]];
#pragma unroll
      for (int q = 0; q < TB; ++q) dv[q] = dz[r * ldz + b[q]];
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int q = 0; q < TB; ++q) acc[i][q] = fmaf(av[i], dv[q], acc[i][q]);
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

__device__ __forceinline__ void ft_grad_w(const float* act, int lda,
                                          const float* dz, int ldz, int rows,
                                          int in, int out, float* g) {
  const int threads = blockDim.x;
  if (((in + 3) / 4) * ((out + 3) / 4) >= threads)
    ft_grad_w_tiled<4, 4>(act, lda, dz, ldz, rows, in, out, g);
  else if (((in + 1) / 2) * ((out + 1) / 2) >= threads)
    ft_grad_w_tiled<2, 2>(act, lda, dz, ldz, rows, in, out, g);
  else
    ft_grad_w_tiled<1, 1>(act, lda, dz, ldz, rows, in, out, g);
}

// dzn[r][a] = (sum over b of dz[r][b] * w[a][b]) * (act[r][a] > 0), for
// r < rows and a < in (w is the layer's (in, out) weight, act its input).
// Each thread owns TR rows interleaved across the warp (odd strides: no bank
// conflicts) x TJ neighbouring a's (weight loads shared with the warp).
template <int TR, int TJ>
__device__ __forceinline__ void ft_grad_h_tiled(const float* dz, int ldz,
                                                const float* w, int in,
                                                int out, const float* act,
                                                int lda, int rows, float* dzn,
                                                int ldn) {
  const int rgroups = (rows + TR - 1) / TR;
  const int jgroups = (in + TJ - 1) / TJ;
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
#pragma unroll 4
    for (int b = 0; b < out; ++b) {
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
        const float live = act[r[i] * lda + a[q]] > 0.f ? 1.f : 0.f;
        dzn[r[i] * ldn + a[q]] = acc[i][q] * live;
      }
    }
  }
}

__device__ __forceinline__ void ft_grad_h(const float* dz, int ldz,
                                          const float* w, int in, int out,
                                          const float* act, int lda, int rows,
                                          float* dzn, int ldn) {
  const int threads = blockDim.x;
  if (((rows + 3) / 4) * ((in + 3) / 4) >= threads)
    ft_grad_h_tiled<4, 4>(dz, ldz, w, in, out, act, lda, rows, dzn, ldn);
  else if (((rows + 1) / 2) * ((in + 1) / 2) >= threads)
    ft_grad_h_tiled<2, 2>(dz, ldz, w, in, out, act, lda, rows, dzn, ldn);
  else
    ft_grad_h_tiled<1, 1>(dz, ldz, w, in, out, act, lda, rows, dzn, ldn);
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
  float* p = smem;
  float* xt = p + ft_round4(D);
  float* act[FT_MAX_LAYERS];
  float* q = xt + rp * din;
  for (int l = 0; l < nl; ++l) {
    act[l] = q;
    q += rp * ft_act_stride(md.dims[l + 1]);
  }
  float* dz0 = q;
  float* dz1 = dz0 + rp * a.ldmax;
  float* rowm = dz1 + rp * a.ldmax;
  int* rowy = reinterpret_cast<int*>(rowm + rp);
  float* red = rowm + 2 * rp;
  float* counts = red + 32;
  const int ldk = ft_act_stride(k);

  // The confusion counts are added to in phase C only.
  for (long long i = gtid; i < (long long)C * k * k; i += gthreads)
    a.conf[i] = 0.f;

  // ---- Phase A: per (chunk, client): forward, loss partial, backward.
  int staged = -1, denom_client = -1;
  float denom = 1.f;
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
    if (c != staged) {
      ft_copy_to_shared(p, a.params + (size_t)c * D, D);
      staged = c;
    }
    ft_copy_to_shared(xt, a.x + g0 * din, rows * din);
    if (tid < rows) {
      rowm[tid] = a.mask[g0 + tid];
      rowy[tid] = a.y[g0 + tid];
    }
    __syncthreads();

    // 1. Forward, keeping every layer's output (K3's FMA order).
    const float* cur = xt;
    int ldc = din;
    for (int l = 0; l < nl; ++l) {
      const int in = md.dims[l];
      const int out = md.dims[l + 1];
      const float* w = p + a.offs[l];
      ft_layer_regs(cur, ldc, in, w, w + in * out, out, l < nl - 1, rows,
                    act[l], ft_act_stride(out));
      __syncthreads();
      cur = act[l];
      ldc = ft_act_stride(out);
    }

    // 2. Log-softmax, the loss partial and dz at the logits, a row a thread.
    float ll_m = 0.f;
    if (tid < rows) {
      const float* z = act[nl - 1] + tid * ldk;
      float zmax = z[0];
      for (int j = 1; j < k; ++j) zmax = fmaxf(zmax, z[j]);
      float se = 0.f;
      for (int j = 0; j < k; ++j) se += expf(z[j] - zmax);
      const float lse = logf(se);
      const int label = rowy[tid];
      const float m = rowm[tid];
      float ll = 0.f;
      for (int j = 0; j < k; ++j) {
        const float lp = (z[j] - zmax) - lse;
        const float oh = j == label ? 1.f : 0.f;
        ll += lp * oh;
        dz0[tid * ldk + j] = (expf(lp) * m - oh * m) / denom;
      }
      ll_m = ll * m;
    }
    const float part = ft_block_sum(ll_m, red);  // also publishes dz0
    if (tid == 0) a.loss_part[(size_t)kc * C + c] = part;

    // 3. Backward, last layer first; the chunk's gradient goes to gp.
    float* dz = dz0;
    float* dzn = dz1;
    int ldz = ldk;
    for (int l = nl - 1; l >= 0; --l) {
      const int in = md.dims[l];
      const int out = md.dims[l + 1];
      const float* ain = l == 0 ? xt : act[l - 1];
      const int lda = l == 0 ? din : ft_act_stride(in);
      float* gl = gp + a.offs[l];
      ft_grad_w(ain, lda, dz, ldz, rows, in, out, gl);
      for (int j = tid; j < out; j += blockDim.x) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) s += dz[r * ldz + j];
        gl[in * out + j] = s;
      }
      if (l > 0) {
        ft_grad_h(dz, ldz, p + a.offs[l], in, out, ain, lda, rows, dzn,
                  ft_act_stride(in));
        __syncthreads();
        float* t = dz;
        dz = dzn;
        dzn = t;
        ldz = ft_act_stride(in);
      }
    }
    __syncthreads();  // the tile's buffers are free for the next item
  }
  grid.sync();

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
  grid.sync();

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
  // ... and per (chunk, client) the eval of the trained params.
  staged = -1;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c = item / a.chunks;
    const int kc = item - c * a.chunks;
    const int row0 = kc * rp;
    const int rows = min(rp, a.n - row0);
    const size_t g0 = (size_t)c * a.n + row0;
    if (!__syncthreads_or(tid < rows && a.mask[g0 + tid] != 0.f)) continue;
    if (c != staged) {
      ft_copy_from_l2(p, a.trained + (size_t)c * D, D);
      staged = c;
    }
    ft_copy_to_shared(xt, a.x + g0 * din, rows * din);
    for (int i = tid; i < k * k; i += blockDim.x) counts[i] = 0.f;
    __syncthreads();
    const float* logits = ft_mlp_tile_forward_regs(p, md, rows, xt, dz0, dz1);
    for (int r = tid; r < rows; r += blockDim.x) {
      const float* h = logits + r * ldk;
      float best = h[0];
      int pred = 0;
      for (int j = 1; j < k; ++j) {
        const float v = h[j];
        if (!isnan(best) && (isnan(v) || v > best)) {
          best = v;
          pred = j;
        }
      }
      const int label = a.y[g0 + r];
      const float mk = a.mask[g0 + r];
      if (mk != 0.f && label >= 0 && label < k)
        atomicAdd(&counts[label * k + pred], mk);
    }
    __syncthreads();
    for (int i = tid; i < k * k; i += blockDim.x)
      if (counts[i] != 0.f)
        atomicAdd(&a.conf[(size_t)c * k * k + i], counts[i]);
    __syncthreads();
  }
}

// The most blocks of the kernel that can be resident at once on `dev` with
// `smem_bytes` of shared memory each: a grid barrier needs every block
// resident. The loop that launches K5 is host-bound, so the attribute and
// occupancy queries run once per (device, bytes) and their answer is kept.
// The shared-memory attribute only grows, so every answer kept stays valid.
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

// params, mu, nu (C, D); count (C,) int32; x (C, n, dims[0]); y (C, n) int32;
// mask (C, n); weights (C,); dims a host array of n_layers + 1; adam a host
// array {lr0, gamma, step_size, b1, 1 - b1, b2, 1 - b2, eps}. rows_per_chunk
// and smem_bytes are the wrapper's plan (_fused_round_plan); a byte count
// that does not hold the layout above is refused. scratch holds
// chunks * C * D + chunks * C + C + C * D floats. Outputs: params_out, mu_out,
// nu_out (C, D), count_out (C,) int32, loss (C,), conf (C, K, K). One
// cooperative launch; returns its cudaError_t (a refused launch, e.g.
// cudaErrorCooperativeLaunchTooLarge, included).
extern "C" int ft_fused_round(const float* params, const float* mu,
                              const float* nu, const int* count,
                              const float* x, const int* y, const float* mask,
                              const float* weights, int clients, int n,
                              const int* dims, int n_layers, const float* adam,
                              int rows_per_chunk, int smem_bytes,
                              float* scratch, float* params_out, float* mu_out,
                              float* nu_out, int* count_out, float* loss,
                              float* conf, void* stream) {
  if (clients < 1 || n < 1 || n_layers < 1 || n_layers > FT_MAX_LAYERS ||
      rows_per_chunk < 1 || rows_per_chunk > FT_ROUND_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  FtRound a;
  int widest;
  a.md = ft_make_dims(dims, n_layers, &widest);
  int off = 0, ldsum = 0, ldmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    a.offs[l] = off;
    off += dims[l] * dims[l + 1] + dims[l + 1];
    ldsum += ft_act_stride(dims[l + 1]);
    ldmax = std::max(ldmax, ft_act_stride(dims[l + 1]));
  }
  const int k = dims[n_layers];
  const size_t need =
      sizeof(float) *
      ((size_t)ft_round4(off) +
       (size_t)rows_per_chunk * (dims[0] + ldsum + 2 * ldmax + 2) + 32 +
       (size_t)k * k);
  if (smem_bytes < 0 || need > (size_t)smem_bytes)
    return (int)cudaErrorInvalidValue;
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
  a.clients = clients;
  a.n = n;
  a.num_params = off;
  a.rows_per = rows_per_chunk;
  a.chunks = chunks;
  a.ldmax = ldmax;
  a.lr0 = adam[0];
  a.gamma = adam[1];
  a.step_size = adam[2];
  a.b1 = adam[3];
  a.one_minus_b1 = adam[4];
  a.b2 = adam[5];
  a.one_minus_b2 = adam[6];
  a.eps = adam[7];

  int dev, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = ft_round_resident_blocks(dev, smem_bytes, &resident);
  if (err != cudaSuccess) return (int)err;
  // Enough blocks for every work item and for phase B's elements, but never
  // more than can be resident at once (a grid barrier needs all of them).
  const long long items = (long long)chunks * clients;
  const long long elems = ((long long)cd + FT_ROUND_THREADS - 1) /
                          FT_ROUND_THREADS;
  const int blocks =
      (int)std::min<long long>(resident, std::max(items, elems));
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)ft_fused_round_kernel,
                                    dim3(blocks), dim3(FT_ROUND_THREADS), args,
                                    (size_t)smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
