// Device-side MLP forwards for the eval kernels: the Linear -> ReLU -> ... ->
// Linear stack of one model over a tile of rows, with the model's flat
// parameters and the activation buffers in shared memory.
// ft_mlp_tile_forward (K3, mlp_forward.cu) computes one output per thread;
// ft_mlp_tile_forward_regs (K2, eval_confusion.cu; K5's eval, fused_round.cu)
// is register-tiled, with the same arithmetic.
//
// Flat parameter layout (fedtpu_torch/models/mlp.py): for each layer, w as
// (in, out) row-major, then b (out).
#pragma once

#include <cuda_runtime.h>

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

// Forward of `rows` rows held in `buf0` (stride dims[0]) through the model
// whose parameters are at `p`; returns the buffer (buf0 or buf1) that holds
// the logits. Activations of a layer with width o are stored row-major at
// stride o, the logits at stride dims[n_layers]. The caller must
// __syncthreads() after filling `p` and `buf0`; the result is visible to the
// whole block on return.
// Each output is a sequential fp32 FMA chain over the inputs, plus the bias,
// then ReLU on hidden layers (NaN passes through ReLU, as torch.relu).
__device__ __forceinline__ float* ft_mlp_tile_forward(const float* p,
                                                      const MlpDims& md,
                                                      int rows, float* buf0,
                                                      float* buf1) {
  float* cur = buf0;
  float* nxt = buf1;
  int off = 0;
  for (int l = 0; l < md.n_layers; ++l) {
    const int in = md.dims[l];
    const int out = md.dims[l + 1];
    const float* w = p + off;
    off += in * out;
    const float* b = p + off;
    off += out;
    const bool relu = l < md.n_layers - 1;
    for (int idx = threadIdx.x; idx < rows * out; idx += blockDim.x) {
      const int r = idx / out;
      const int j = idx - r * out;
      const float* h = cur + r * in;
      float acc = 0.f;
      for (int i = 0; i < in; ++i) acc = fmaf(h[i], w[i * out + j], acc);
      acc += b[j];
      nxt[idx] = (relu && acc < 0.f) ? 0.f : acc;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Register-tiled forward, used by K2 (eval_confusion.cu).
//
// Same arithmetic as ft_mlp_tile_forward, output by output: a fp32 FMA chain
// over the inputs from i = 0 up, starting at 0, then + bias, then ReLU on
// hidden layers. So its logits are bit for bit those of ft_mlp_tile_forward
// (K3) on the same rows. What differs is the schedule: each thread owns a
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

// Shared memory one tile needs: the parameters, two activation buffers of
// rows x widest, and `extra` floats.
static inline size_t ft_tile_smem_bytes(int num_params, int rows, int widest,
                                        int extra) {
  return sizeof(float) *
         ((size_t)num_params + 2 * (size_t)rows * widest + (size_t)extra);
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
