// K2: per-client fused eval -> masked confusion counts.
//
// Replaces: fedtpu/ops/pallas_kernels.py::fused_eval_confusion
// (_eval_conf_kernel), the in-round eval of every round: each client's own
// MLP forward on its own shard, first-max argmax, masked one-hot confusion
// (C, K, K).
//
// Bound on the card: fp32 CUDA-core work on the real (unmasked) rows,
// 2 * rows * sum(in*out) flops (8,000 rows of income at 14->50->200->2:
// ~180 MFLOP, ~2.7 us at 67 TFLOP/s); the bytes are small (x is 448 KB at
// income-8). Padded rows are no work: the clients' shards are padded to the
// longest one, and at income-32-noniid 77 % of the batch's rows are padding.
//
// Why fp32 on the CUDA cores and not the tensor cores: TF32 keeps 10
// mantissa bits. The card's counts may differ from the plain version's only
// on near-tie rows (top-two logit gap below 1e-5 relative), and the run's
// early-stop round must equal the CPU's; TF32, or a split-TF32 scheme, would
// move argmaxes far from any tie and break both.
//
// Design: grid (row tiles, clients), one row tile per block.
// - The block first reads its tile's mask (one row per thread) and exits if
//   it is all zero: padding adds nothing to the counts. The mask is read,
//   not assumed to be padded at the tail.
// - A live block stages its client's parameters (45 KB at 14->50->200->2)
//   global -> shared with one bulk asynchronous copy on an mbarrier, while
//   its x tile comes in with cp.async (ft_stage_begin / ft_stage_end in
//   mlp_forward.cuh, shared with K3).
// - The forward is register-tiled (ft_mlp_tile_forward_regs in
//   mlp_forward.cuh), K3's forward, so its logits, and the counts, are bit
//   for bit those built from K3's logits.
// - First maximum of each row (strict '>', NaN counts as the maximum, as
//   torch.argmax); (label, prediction) pairs of unmasked rows are counted in
//   shared memory, then one global atomicAdd per non-zero cell. Masks are
//   0/1 and counts stay below 2^24, so the float sums are exact whatever
//   order the atomics land in.
//
// Shared memory (floats): a 4-float header (the mbarrier), the parameters
// with 3 floats of alignment slack rounded up to 4, one x tile of rows x
// dims[0], two activation tiles of rows x the widest layer output at an odd
// stride, and K x K counts. The wrapper's _eval_plan
// (fedtpu_torch/ops/cuda_kernels.py) picks the tile and the byte count;
// ft_eval_confusion refuses a byte count that does not hold this layout.
#include <algorithm>

#include "mlp_forward.cuh"

__global__ void __launch_bounds__(FT_THREADS, 2)
ft_eval_confusion_kernel(const float* __restrict__ params, int num_params,
                         MlpDims md, const float* __restrict__ x,
                         const int* __restrict__ y,
                         const float* __restrict__ mask, int n, int rows_per,
                         int ldmax, float* __restrict__ conf) {
  extern __shared__ __align__(16) float smem[];
  const int k = md.dims[md.n_layers];
  const int din = md.dims[0];
  const int c = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * rows_per;
  const int rows = (int)min((long long)rows_per, n - row0);
  const size_t g0 = (size_t)c * n + row0;   // the tile's first row in (C, n)
  if (!__syncthreads_or(threadIdx.x < rows && mask[g0 + threadIdx.x] != 0.f))
    return;

  float* xt = smem + ft_stage_floats(num_params);
  float* act0 = xt + rows_per * din;
  float* act1 = act0 + rows_per * ldmax;
  float* counts = act1 + rows_per * ldmax;
  const FtStage st =
      ft_stage_begin(smem, params + (size_t)c * num_params, num_params, xt,
                     x + g0 * din, rows * din);
  for (int i = threadIdx.x; i < k * k; i += blockDim.x) counts[i] = 0.f;
  ft_stage_end(smem, st);

  const float* logits =
      ft_mlp_tile_forward_regs(st.p, md, rows, xt, act0, act1);
  const int ldk = ft_act_stride(k);
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
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
    const int label = y[g0 + r];
    const float mk = mask[g0 + r];
    if (mk != 0.f && label >= 0 && label < k)
      atomicAdd(&counts[label * k + pred], mk);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k * k; i += blockDim.x)
    if (counts[i] != 0.f) atomicAdd(&conf[(size_t)c * k * k + i], counts[i]);
}

// params (C, num_params), x (C, n, dims[0]), y (C, n) int32, mask (C, n),
// conf (C, K, K) zeroed by the caller; dims is a host array of n_layers + 1.
// rows_per_block and smem_bytes are the wrapper's plan (_eval_plan); a byte
// count that does not hold the layout above is refused. Grid: (row tiles,
// clients), one tile per block. Returns the cudaError_t of the launch.
extern "C" int ft_eval_confusion(const float* params, int num_params,
                                 const int* dims, int n_layers, const float* x,
                                 const int* y, const float* mask, int clients,
                                 int n, int rows_per_block, int smem_bytes,
                                 float* conf, void* stream) {
  if (rows_per_block < 1 || rows_per_block > FT_THREADS)
    return (int)cudaErrorInvalidValue;
  int widest;
  const MlpDims md = ft_make_dims(dims, n_layers, &widest);
  int ldmax = 0;
  for (int l = 1; l <= n_layers; ++l)
    ldmax = std::max(ldmax, ft_act_stride(dims[l]));
  const int k = dims[n_layers];
  const size_t need =
      sizeof(float) * ((size_t)ft_stage_floats(num_params) +
                       (size_t)rows_per_block * (dims[0] + 2 * ldmax) +
                       (size_t)k * k);
  if (smem_bytes < 0 || need > (size_t)smem_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ft_eval_confusion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block, clients);
  ft_eval_confusion_kernel<<<grid, FT_THREADS, smem_bytes,
                             (cudaStream_t)stream>>>(
      params, num_params, md, x, y, mask, n, rows_per_block, ldmax, conf);
  return (int)cudaGetLastError();
}
