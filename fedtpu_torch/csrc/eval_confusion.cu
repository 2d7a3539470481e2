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
// - A live block, when its client's parameters fit in shared memory (every
//   income shape), stages them global -> shared with one bulk asynchronous
//   copy on an mbarrier, while its x tile comes in with cp.async
//   (ft_stage_begin / ft_stage_end in mlp_forward.cuh, shared with K3).
//   When they do not fit, the block streams each layer's weights through
//   two shared buffers instead (ft_mlp_tile_forward_streamed), with the
//   same bits. The wrapper's plan picks the path from the shapes.
// - The forward is register-tiled with K3's FMA order (mlp_forward.cuh), so
//   its logits, and the counts, are bit for bit those built from K3's
//   logits, on either path.
// - First maximum of each row (strict '>', NaN counts as the maximum, as
//   torch.argmax); (label, prediction) pairs of unmasked rows are counted in
//   a K x K tile in shared memory, then one global atomicAdd per non-zero
//   cell; where the plan cannot fit the tile (many classes), each row adds
//   straight into global memory. Masks are 0/1 and counts stay below 2^24,
//   so the float sums are exact whatever order the atomics land in.
//
// Shared memory (floats): the resident staging layout (a 4-float header,
// the parameters with 3 floats of alignment slack rounded up to 4) or the
// streamed one (a 4-float header, two weight buffers of `cap` floats); one
// x tile of rows x dims[0]; two activation tiles of rows x the widest layer
// output at an odd stride; the K x K counts when they are kept in shared
// memory. The wrapper's _eval_plan (fedtpu_torch/ops/cuda_kernels.py) picks
// the tile, the path, the buffers and where the counts go;
// ft_eval_confusion refuses a byte count that does not hold its layout.
#include <algorithm>

#include "mlp_forward.cuh"

template <bool STREAMED>
__global__ void __launch_bounds__(FT_THREADS, 2)
ft_eval_confusion_kernel(const float* __restrict__ params, int num_params,
                         MlpDims md, const float* __restrict__ x,
                         const int* __restrict__ y,
                         const float* __restrict__ mask, int n, int rows_per,
                         int ldmax, int cap, bool shared_counts,
                         float* __restrict__ conf) {
  extern __shared__ __align__(16) float smem[];
  const int k = md.dims[md.n_layers];
  const int din = md.dims[0];
  const int c = blockIdx.y;
  const long long row0 = (long long)blockIdx.x * rows_per;
  const int rows = (int)min((long long)rows_per, n - row0);
  const size_t g0 = (size_t)c * n + row0;   // the tile's first row in (C, n)
  if (!__syncthreads_or(threadIdx.x < rows && mask[g0 + threadIdx.x] != 0.f))
    return;

  const float* p = params + (size_t)c * num_params;
  float* xt = smem + (STREAMED ? ft_stream_floats(cap)
                               : ft_stage_floats(num_params));
  float* act0 = xt + rows_per * din;
  float* act1 = act0 + rows_per * ldmax;
  float* counts = act1 + rows_per * ldmax;
  const float* logits;
  if (STREAMED) {
    ft_stream_begin(smem, p, md, cap, xt, x + g0 * din, rows * din);
    if (shared_counts)
      for (int i = threadIdx.x; i < k * k; i += blockDim.x) counts[i] = 0.f;
    ft_stage_end(smem, {nullptr, false});
    logits = ft_mlp_tile_forward_streamed(smem, p, md, cap, rows, xt, act0,
                                          act1);
  } else {
    const FtStage st =
        ft_stage_begin(smem, p, num_params, xt, x + g0 * din, rows * din);
    if (shared_counts)
      for (int i = threadIdx.x; i < k * k; i += blockDim.x) counts[i] = 0.f;
    ft_stage_end(smem, st);
    logits = ft_mlp_tile_forward_regs(st.p, md, rows, xt, act0, act1);
  }
  const int ldk = ft_act_stride(k);
  float* cc = conf + (size_t)c * k * k;
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
      atomicAdd(&(shared_counts ? counts : cc)[label * k + pred], mk);
  }
  if (!shared_counts) return;
  __syncthreads();
  for (int i = threadIdx.x; i < k * k; i += blockDim.x)
    if (counts[i] != 0.f) atomicAdd(&cc[i], counts[i]);
}

// params (C, num_params), x (C, n, dims[0]), y (C, n) int32, mask (C, n),
// conf (C, K, K) zeroed by the caller; dims is a host array of n_layers + 1.
// rows_per_block, cap (floats in each weight buffer of the streamed path; 0
// for the resident one), shared_counts and smem_bytes are the wrapper's
// plan (_eval_plan); a byte count that does not hold the layout above, or a
// buffer that does not hold one input row of the widest layer, is refused.
// Grid: (row tiles, clients), one tile per block. Returns the cudaError_t
// of the launch.
extern "C" int ft_eval_confusion(const float* params, int num_params,
                                 const int* dims, int n_layers, const float* x,
                                 const int* y, const float* mask, int clients,
                                 int n, int rows_per_block, int cap,
                                 int shared_counts, int smem_bytes,
                                 float* conf, void* stream) {
  if (rows_per_block < 1 || rows_per_block > FT_THREADS || n_layers < 1 ||
      n_layers > FT_MAX_LAYERS || cap < 0 || cap % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int widest;
  const MlpDims md = ft_make_dims(dims, n_layers, &widest);
  int ldmax = 0, outmax = 0;
  for (int l = 1; l <= n_layers; ++l) {
    ldmax = std::max(ldmax, ft_act_stride(dims[l]));
    outmax = std::max(outmax, dims[l]);
  }
  if (cap > 0 && cap - 3 < outmax) return (int)cudaErrorInvalidValue;
  const int k = dims[n_layers];
  const size_t need =
      sizeof(float) *
      ((size_t)(cap > 0 ? ft_stream_floats(cap) : ft_stage_floats(num_params)) +
       (size_t)rows_per_block * (dims[0] + 2 * ldmax) +
       (shared_counts ? (size_t)k * k : 0));
  if (smem_bytes < 0 || need > (size_t)smem_bytes)
    return (int)cudaErrorInvalidValue;
  auto kernel = cap > 0 ? ft_eval_confusion_kernel<true>
                        : ft_eval_confusion_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block, clients);
  kernel<<<grid, FT_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      params, num_params, md, x, y, mask, n, rows_per_block, ldmax, cap,
      shared_counts != 0, conf);
  return (int)cudaGetLastError();
}
