// Device-side pieces of the eval kernels: the Linear -> ReLU -> ... ->
// Linear stack of one model over a tile of rows, register-tiled
// (ft_mlp_tile_forward_regs: K2 eval_confusion.cu, K3 mlp_forward.cu, K5's
// train forward and eval, fused_round.cu), and the staging of one model's
// parameters and one x tile into shared memory (ft_stage_begin /
// ft_stage_end: K2 and K3).
//
// Flat parameter layout (fedtpu_torch/models/mlp.py): for each layer, w as
// (in, out) row-major, then b (out).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#define FT_MAX_LAYERS 16
#define FT_THREADS 256

struct MlpDims {
  int n_layers;                  // number of Linear layers
  int dims[FT_MAX_LAYERS + 1];   // (input_dim, *hidden_sizes, num_classes)
};

// Block-cooperative copy of `count` floats into shared memory; neighbouring
// threads read neighbouring addresses.
__device__ __forceinline__ void ft_copy_to_shared(float* dst,
                                                  const float* __restrict__ src,
                                                  int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// Register-tiled forward.
//
// Each output is a sequential fp32 FMA chain over the inputs from i = 0 up,
// starting at 0, then + bias, then ReLU on hidden layers (NaN passes through
// ReLU, as torch.relu). So K2's and K3's logits of the same rows are bit
// for bit equal, whatever tile either runs. The schedule: each thread owns a
// micro-tile of TR rows x TJ outputs with TR * TJ independent accumulators,
// so one shared-memory load of an activation feeds TJ FMAs and one load of a
// weight feeds TR. A thread's outputs are interleaved (j = jt + q * groups),
// so the threads of a warp read neighbouring weights (no bank conflicts) and
// share their activation loads (broadcast).
//
// Activations of a layer with width o are stored at the odd stride
// ft_act_stride(o), so rows that lie in one warp's reads fall in different
// banks.
__host__ __device__ __forceinline__ int ft_act_stride(int o) { return o | 1; }

// v rounded up to a multiple of 4 (floats: 16 bytes).
__host__ __device__ __forceinline__ int ft_round4(int v) {
  return (v + 3) & ~3;
}

template <int TR, int TJ>
__device__ __forceinline__ void ft_layer_microtiled(const float* h, int ldh,
                                                    int in, const float* w,
                                                    const float* b, int out,
                                                    bool relu, int rows,
                                                    float* o, int ldo) {
  const int rgroups = (rows + TR - 1) / TR;
  const int jgroups = (out + TJ - 1) / TJ;
  for (int t = threadIdx.x; t < rgroups * jgroups; t += blockDim.x) {
    const int rt = t / jgroups;
    const int jt = t - rt * jgroups;
    int r[TR], j[TJ];
#pragma unroll
    for (int a = 0; a < TR; ++a) r[a] = min(rt * TR + a, rows - 1);
#pragma unroll
    for (int q = 0; q < TJ; ++q) j[q] = min(jt + q * jgroups, out - 1);
    float acc[TR][TJ];
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int q = 0; q < TJ; ++q) acc[a][q] = 0.f;
#pragma unroll 8
    for (int i = 0; i < in; ++i) {
      float hv[TR], wv[TJ];
#pragma unroll
      for (int a = 0; a < TR; ++a) hv[a] = h[r[a] * ldh + i];
#pragma unroll
      for (int q = 0; q < TJ; ++q) wv[q] = w[i * out + j[q]];
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int q = 0; q < TJ; ++q) acc[a][q] = fmaf(hv[a], wv[q], acc[a][q]);
    }
#pragma unroll
    for (int a = 0; a < TR; ++a) {
      if (rt * TR + a >= rows) continue;
#pragma unroll
      for (int q = 0; q < TJ; ++q) {
        if (jt + q * jgroups >= out) continue;
        const float v = acc[a][q] + b[j[q]];
        o[r[a] * ldo + j[q]] = (relu && v < 0.f) ? 0.f : v;
      }
    }
  }
}

// One layer of the register-tiled forward: the largest micro-tile that still
// gives every thread work, 4 x 4, then 2 x 2, then 1 x 1. The tile changes
// the schedule only, never an output's FMA order.
__device__ __forceinline__ void ft_layer_regs(const float* h, int ldh, int in,
                                              const float* w, const float* b,
                                              int out, bool relu, int rows,
                                              float* o, int ldo) {
  const int threads = blockDim.x;
  if (((rows + 3) / 4) * ((out + 3) / 4) >= threads)
    ft_layer_microtiled<4, 4>(h, ldh, in, w, b, out, relu, rows, o, ldo);
  else if (((rows + 1) / 2) * ((out + 1) / 2) >= threads)
    ft_layer_microtiled<2, 2>(h, ldh, in, w, b, out, relu, rows, o, ldo);
  else
    ft_layer_microtiled<1, 1>(h, ldh, in, w, b, out, relu, rows, o, ldo);
}

// Forward of `rows` rows of x (in shared memory, stride dims[0]) through the
// model at `p`, through the activation buffers act0 and act1 (each rows x
// ft_act_stride(widest output)); returns the buffer that holds the logits
// (stride ft_act_stride(dims[n_layers])). The caller must __syncthreads()
// after filling `p` and `x`; the result is visible to the whole block on
// return.
__device__ __forceinline__ const float* ft_mlp_tile_forward_regs(
    const float* p, const MlpDims& md, int rows, const float* x, float* act0,
    float* act1) {
  const float* cur = x;
  int ldc = md.dims[0];
  float* nxt = act0;
  int off = 0;
  for (int l = 0; l < md.n_layers; ++l) {
    const int in = md.dims[l];
    const int out = md.dims[l + 1];
    const float* w = p + off;
    off += in * out;
    const float* b = p + off;
    off += out;
    const int ldo = ft_act_stride(out);
    ft_layer_regs(cur, ldc, in, w, b, out, l < md.n_layers - 1, rows, nxt,
                  ldo);
    __syncthreads();
    cur = nxt;
    ldc = ldo;
    nxt = nxt == act0 ? act1 : act0;
  }
  return cur;
}

// Staging of one model's parameters and one x tile into shared memory, for
// a block that then runs ft_mlp_tile_forward_regs on the tile.
//
// Layout at `smem` (16-byte aligned): a 4-float header (the mbarrier), then
// ft_round4(count + 3) floats that hold the `count` parameters, placed so
// that their 16-byte aligned middle lies on a 16-byte boundary as it does
// in global memory. The 16-byte aligned middle comes in with one bulk
// asynchronous copy (cp.async.bulk, completion on the mbarrier), the head
// and tail that are not 16-byte aligned with plain loads, the x tile with
// cp.async (4 bytes each: its rows may have any alignment). No thread
// spends registers on the bulk of the copy.
// Floats the staging layout takes ahead of whatever follows it (the x
// tile): the header and the parameters with their alignment slack.
__host__ __device__ __forceinline__ int ft_stage_floats(int count) {
  return 4 + ft_round4(count + 3);
}

__device__ __forceinline__ uint32_t ft_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

struct FtStage {
  float* p;    // the parameters in shared memory
  bool bulk;   // a bulk copy is in flight on the mbarrier
};

// Issues the copies; every thread of the block must call it, then
// ft_stage_end. Between the two the block may write other shared memory.
__device__ __forceinline__ FtStage ft_stage_begin(float* smem,
                                                  const float* src, int count,
                                                  float* xt, const float* xg,
                                                  int xcount) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int head = min(count, (int)((16 - ((uintptr_t)src & 15)) & 15) / 4);
  const int bulk = (count - head) & ~3;
  float* p = smem + 4 + ((4 - head) & 3);
  if (threadIdx.x == 0 && bulk > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     ft_smem_addr(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(ft_smem_addr(bar)),
                 "r"(bulk * 4)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(ft_smem_addr(p + head)),
        "l"(src + head), "r"(bulk * 4), "r"(ft_smem_addr(bar))
        : "memory");
  }
  for (int i = threadIdx.x; i < xcount; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     ft_smem_addr(xt + i)),
                 "l"(xg + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < head; i += blockDim.x) p[i] = src[i];
  for (int i = head + bulk + threadIdx.x; i < count; i += blockDim.x)
    p[i] = src[i];
  return {p, bulk > 0};
}

// Waits for ft_stage_begin's copies. On return the parameters, the x tile
// and whatever the block wrote to shared memory in between are visible to
// the whole block. The __syncthreads() also puts the mbarrier's init before
// any thread's wait on it, which the wait needs.
__device__ __forceinline__ void ft_stage_end(float* smem, const FtStage& st) {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (st.bulk) {
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred r;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 r, [%1], 0;\n"
          " selp.u32 %0, 1, 0, r;\n}\n"
          : "=r"(done)
          : "r"(ft_smem_addr(smem))
          : "memory");
  }
}

static inline MlpDims ft_make_dims(const int* dims, int n_layers,
                                   int* widest) {
  MlpDims md;
  md.n_layers = n_layers;
  *widest = 0;
  for (int i = 0; i <= n_layers; ++i) {
    md.dims[i] = dims[i];
    if (dims[i] > *widest) *widest = dims[i];
  }
  return md;
}
