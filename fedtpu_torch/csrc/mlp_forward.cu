// K3: fused MLP forward of one model -> logits, over the whole card.
//
// Replaces: fedtpu/ops/pallas_kernels.py::fused_mlp_forward (_mlp_kernel),
// the held-out eval's forward of the global model.
//
// Bound on the card: fp32 CUDA-core work, 2 * N * sum(in*out) + N * sum(out)
// flops (the held-out split, N = 2,000 at 14->50->200->2: 44.9 MFLOP,
// 0.67 us at 67 TFLOP/s); it reads 112 KB of x and 45 KB of parameters and
// writes 16 KB of logits. Launch latency and one pass of parameter staging
// are larger than both, so the design keeps every hidden activation on
// chip, fills the card with row tiles, and stages the parameters without
// spending threads on the copy.
//
// Design: one block per row tile.
// - The tile plan is the wrapper's (_forward_plan in
//   fedtpu_torch/ops/cuda_kernels.py): of the tiles whose block fits in
//   shared memory, the one that gives the busiest SM the least work, with
//   one block's parameter copy counted as 8 rows; threads per block, whole
//   warps up to 256, enough to run the widest layer's 4 x 4 micro-tiles in
//   two passes. At N = 2,000 that is 16-row tiles, 125 blocks on 132 SMs,
//   128 threads each (the fastest of 16 tile x thread pairs that
//   chip_smoke.py times).
// - A block stages the model's parameters global -> shared with one bulk
//   asynchronous copy on an mbarrier and its x tile with cp.async
//   (ft_stage_begin / ft_stage_end in mlp_forward.cuh, shared with K2).
//   A model that does not fit in a block (the plan says so from the shapes)
//   streams each layer's weights through two shared buffers instead
//   (ft_mlp_tile_forward_streamed), with the same bits.
// - The forward is register-tiled (ft_mlp_tile_forward_regs): every output
//   is a sequential fp32 FMA chain from i = 0, then + b, then ReLU, so the
//   logits are bit for bit those of K2's forward (chip_smoke.py holds K2's
//   counts equal to the counts built from K3's logits).
// - A ragged N is masked in the kernel (the last tile runs fewer rows); no
//   padding copies, unlike the Pallas pad-and-slice.
//
// Shared memory (floats): the staging layout of mlp_forward.cuh
// (ft_stage_floats: a 4-float header and the parameters), or the streamed
// one (ft_stream_floats: a 4-float header and two weight buffers); one x
// tile of rows x dims[0], and two activation tiles of rows x the widest
// layer output at an odd stride. ft_mlp_forward refuses a byte count that
// does not hold it.
#include <algorithm>

#include "mlp_forward.cuh"

template <bool STREAMED>
__global__ void __launch_bounds__(FT_THREADS)
ft_mlp_forward_kernel(const float* __restrict__ params, int num_params,
                      MlpDims md, const float* __restrict__ x, int n,
                      int rows_per, int ldmax, int cap,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int k = md.dims[md.n_layers];
  const int din = md.dims[0];
  const long long row0 = (long long)blockIdx.x * rows_per;
  const int rows = (int)min((long long)rows_per, n - row0);
  float* xt = smem + (STREAMED ? ft_stream_floats(cap)
                               : ft_stage_floats(num_params));
  float* act0 = xt + rows_per * din;
  float* act1 = act0 + rows_per * ldmax;
  const float* logits;
  if (STREAMED) {
    ft_stream_begin(smem, params, md, cap, xt, x + row0 * din, rows * din);
    ft_stage_end(smem, {nullptr, false});
    logits = ft_mlp_tile_forward_streamed(smem, params, md, cap, rows, xt,
                                          act0, act1);
  } else {
    const FtStage st = ft_stage_begin(smem, params, num_params, xt,
                                      x + row0 * din, rows * din);
    ft_stage_end(smem, st);
    logits = ft_mlp_tile_forward_regs(st.p, md, rows, xt, act0, act1);
  }
  const int ldk = ft_act_stride(k);
  for (int i = threadIdx.x; i < rows * k; i += blockDim.x) {
    const int r = i / k;
    out[row0 * k + i] = logits[r * ldk + (i - r * k)];
  }
}

// params (num_params,), x (n, dims[0]), out (n, K); dims is a host array of
// n_layers + 1. rows_per_block, threads, cap (floats in each weight buffer
// of the streamed path; 0 for the resident one) and smem_bytes are the
// wrapper's plan (_forward_plan); threads must be whole warps up to
// FT_THREADS, and a byte count that does not hold the layout above, or a
// buffer that does not hold one input row of the widest layer, is refused.
// Grid: one block per row tile. Returns the cudaError_t of the launch.
extern "C" int ft_mlp_forward(const float* params, int num_params,
                              const int* dims, int n_layers, const float* x,
                              int n, int rows_per_block, int threads, int cap,
                              int smem_bytes, float* out, void* stream) {
  if (n < 1 || rows_per_block < 1 || threads < 32 || threads > FT_THREADS ||
      threads % 32 != 0 || n_layers < 1 || n_layers > FT_MAX_LAYERS ||
      cap < 0 || cap % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int widest;
  const MlpDims md = ft_make_dims(dims, n_layers, &widest);
  int ldmax = 0, outmax = 0;
  for (int l = 1; l <= n_layers; ++l) {
    ldmax = std::max(ldmax, ft_act_stride(dims[l]));
    outmax = std::max(outmax, dims[l]);
  }
  if (cap > 0 && cap - 3 < outmax) return (int)cudaErrorInvalidValue;
  const size_t need =
      sizeof(float) *
      ((size_t)(cap > 0 ? ft_stream_floats(cap) : ft_stage_floats(num_params)) +
       (size_t)rows_per_block * (dims[0] + 2 * ldmax));
  if (smem_bytes < 0 || need > (size_t)smem_bytes)
    return (int)cudaErrorInvalidValue;
  auto kernel = cap > 0 ? ft_mlp_forward_kernel<true>
                        : ft_mlp_forward_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + rows_per_block - 1) / rows_per_block);
  kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      params, num_params, md, x, n, rows_per_block, ldmax, cap, out);
  return (int)cudaGetLastError();
}
