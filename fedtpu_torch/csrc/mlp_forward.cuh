// Shared device-side MLP forward for the eval kernels (eval_confusion.cu,
// mlp_forward.cu): the Linear -> ReLU -> ... -> Linear stack of one model
// over a tile of rows, with the model's flat parameters and both activation
// buffers in shared memory.
//
// Flat parameter layout (fedtpu_torch/models/mlp.py): for each layer, w as
// (in, out) row-major, then b (out). Activations of a layer with width o are
// stored row-major at stride o.
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
// the logits (stride dims[n_layers]). The caller must __syncthreads() after
// filling `p` and `buf0`; the result is visible to the whole block on return.
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
