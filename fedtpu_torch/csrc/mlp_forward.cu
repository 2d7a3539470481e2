// K3: fused MLP forward of one model -> logits.
//
// Replaces: fedtpu/ops/pallas_kernels.py::fused_mlp_forward (_mlp_kernel),
// the held-out eval's forward of the global model.
//
// Bound on the card: fp32 CUDA-core work, 2 * N * sum(in*out) flops (the
// held-out split, N = 2,000 at 14->50->200->2: ~44 MFLOP, ~0.7 us at
// 67 TFLOP/s); it reads 112 KB of x and writes 16 KB of logits. Launch
// latency is larger than both, so the design is one launch that keeps every
// hidden activation out of device memory.
//
// Design: one block per tile of rows. Each block copies the model's flat
// parameters and its row tile into dynamic shared memory, runs the forward
// shared with K2 (mlp_forward.cuh), and writes the tile's logits. A ragged N
// is masked in the kernel (the last tile runs fewer rows); no padding
// copies, unlike the Pallas pad-and-slice.
#include "mlp_forward.cuh"

__global__ void ft_mlp_forward_kernel(const float* __restrict__ params,
                                      int num_params, MlpDims md,
                                      const float* __restrict__ x, int n,
                                      int rows_per_block, int widest,
                                      float* __restrict__ out) {
  extern __shared__ float smem[];
  const int k = md.dims[md.n_layers];
  const int din = md.dims[0];
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  float* p = smem;
  float* buf0 = p + num_params;
  float* buf1 = buf0 + rows_per_block * widest;

  ft_copy_to_shared(p, params, num_params);
  ft_copy_to_shared(buf0, x + (size_t)row0 * din, rows * din);
  __syncthreads();

  const float* logits = ft_mlp_tile_forward(p, md, rows, buf0, buf1);
  for (int i = threadIdx.x; i < rows * k; i += blockDim.x)
    out[(size_t)row0 * k + i] = logits[i];
}

// params (num_params,), x (n, dims[0]), out (n, K); dims is a host array of
// n_layers + 1. Returns the cudaError_t of the launch.
extern "C" int ft_mlp_forward(const float* params, int num_params,
                              const int* dims, int n_layers, const float* x,
                              int n, int rows_per_block, float* out,
                              void* stream) {
  int widest;
  const MlpDims md = ft_make_dims(dims, n_layers, &widest);
  const size_t smem = ft_tile_smem_bytes(num_params, rows_per_block, widest, 0);
  cudaError_t err = cudaFuncSetAttribute(
      ft_mlp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block);
  ft_mlp_forward_kernel<<<grid, FT_THREADS, smem, (cudaStream_t)stream>>>(
      params, num_params, md, x, n, rows_per_block, widest, out);
  return (int)cudaGetLastError();
}
