// K2: per-client fused eval -> masked confusion counts.
//
// Replaces: fedtpu/ops/pallas_kernels.py::fused_eval_confusion
// (_eval_conf_kernel), the in-round eval of every round: each client's own
// MLP forward on its own shard, first-max argmax, masked one-hot confusion
// (C, K, K).
//
// Bound on the card: fp32 CUDA-core work, 2 * C * N * sum(in*out) flops
// (income-8: 2 * 8 * 1000 * 11,100 ~ 178 MFLOP, ~2.7 us at 67 TFLOP/s); the
// bytes are small (x is 448 KB). At these sizes a launch costs more than
// either, so the design aims at one launch with no intermediate in device
// memory.
//
// Design: grid (row tiles, clients), so the C = 8 clients spread over many
// SMs. Each block copies its client's whole flat parameter block (45 KB at
// 14->50->200->2; 88 KB at (50, 400)) and its row tile into dynamic shared
// memory, runs the shared forward (mlp_forward.cuh) with fp32 accumulation,
// takes the first maximum of each row (strict '>', NaN counts as the
// maximum, as torch.argmax), and counts (label, prediction) pairs of
// unmasked rows in shared memory. One global atomicAdd per non-zero cell per
// block folds the tile into conf. Masks are 0/1 and counts stay below 2^24,
// so the float sums are exact whatever order the atomics land in. No
// limit on N: rows are tiled, unlike the Pallas kernel's one-pass VMEM
// budget. The host wrapper (fedtpu_torch/ops/cuda_kernels.py) zeroes conf
// and picks rows_per_block so the tile fits in shared memory.
#include "mlp_forward.cuh"

__global__ void ft_eval_confusion_kernel(const float* __restrict__ params,
                                         int num_params, MlpDims md,
                                         const float* __restrict__ x,
                                         const int* __restrict__ y,
                                         const float* __restrict__ mask, int n,
                                         int rows_per_block, int widest,
                                         float* __restrict__ conf) {
  extern __shared__ float smem[];
  const int k = md.dims[md.n_layers];
  const int din = md.dims[0];
  const int c = blockIdx.y;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  float* p = smem;
  float* buf0 = p + num_params;
  float* buf1 = buf0 + rows_per_block * widest;
  float* counts = buf1 + rows_per_block * widest;

  ft_copy_to_shared(p, params + (size_t)c * num_params, num_params);
  ft_copy_to_shared(buf0, x + ((size_t)c * n + row0) * din, rows * din);
  for (int i = threadIdx.x; i < k * k; i += blockDim.x) counts[i] = 0.f;
  __syncthreads();

  const float* logits = ft_mlp_tile_forward(p, md, rows, buf0, buf1);

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* h = logits + r * k;
    float best = h[0];
    int pred = 0;
    for (int j = 1; j < k; ++j) {
      const float v = h[j];
      if (!isnan(best) && (isnan(v) || v > best)) {
        best = v;
        pred = j;
      }
    }
    const size_t g = (size_t)c * n + row0 + r;
    const int label = y[g];
    const float m = mask[g];
    if (m != 0.f && label >= 0 && label < k)
      atomicAdd(&counts[label * k + pred], m);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k * k; i += blockDim.x)
    if (counts[i] != 0.f) atomicAdd(&conf[(size_t)c * k * k + i], counts[i]);
}

// params (C, num_params), x (C, n, dims[0]), y (C, n) int32, mask (C, n),
// conf (C, K, K) zeroed by the caller; dims is a host array of n_layers + 1.
// Returns the cudaError_t of the launch.
extern "C" int ft_eval_confusion(const float* params, int num_params,
                                 const int* dims, int n_layers, const float* x,
                                 const int* y, const float* mask, int clients,
                                 int n, int rows_per_block, float* conf,
                                 void* stream) {
  int widest;
  const MlpDims md = ft_make_dims(dims, n_layers, &widest);
  const int k = dims[n_layers];
  const size_t smem = ft_tile_smem_bytes(num_params, rows_per_block, widest,
                                         k * k);
  cudaError_t err = cudaFuncSetAttribute(
      ft_eval_confusion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block, clients);
  ft_eval_confusion_kernel<<<grid, FT_THREADS, smem, (cudaStream_t)stream>>>(
      params, num_params, md, x, y, mask, n, rows_per_block, widest, conf);
  return (int)cudaGetLastError();
}
