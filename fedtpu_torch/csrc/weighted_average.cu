// K1: FedAvg, the weighted average over the clients axis, in one launch:
// returned as one (D,) row, or written into every client slot with the
// zero-participant carry-over decided on the device (broadcast mode).
//
// Replaces: fedtpu/ops/pallas_kernels.py::weighted_average_clients
// (_wavg_kernel): sum_c (w_c / max(sum w, 1e-30)) * x_c as one (1,C)@(C,D)
// contraction at Precision.HIGHEST. The broadcast mode also takes in what
// the round does after it (fedtpu/parallel/round.py:874,
// jnp.where(total > 0, bcast(glob), p)): out[c] = the average for every c
// when sum w > 0, else out[c] = x[c].
//
// Bound on the card: bytes, with launch latency above them. The (D,) mode
// reads C*D + C floats and writes D; the broadcast mode reads C*D + C and
// writes C*D (income-8, C = 8, D = 11,352: 0.36 / 0.73 MB, 0.12 / 0.22 us
// at 3.35 TB/s). Its 2*C*D flops are nothing beside that.
//
// Design: one column a thread, one kernel for both modes (a template flag),
// one path for every width and alignment.
// - The client loop issues the loads of 8 client rows before their FMAs,
//   so a thread has 8 loads in flight, not one dependent chain of C.
// - Every warp sums the C weights itself with shuffles, so no thread sums
//   them serially and no shared memory or __syncthreads() is needed; the
//   butterfly gives every lane, and so every block, the same bits. Each
//   weight is normalised as the Pallas function does, w_c / max(total,
//   1e-30), in fp32 (IEEE division).
// - The accumulation over clients is an fp32 FMA chain in client order from
//   0, no TF32: fedtpu's Precision.HIGHEST.
// - Broadcast mode writes the average into all C rows, or, when the total is
//   not > 0 (no participant; NaN too, as torch.where(sum > 0, ...)), the
//   thread's column of x back unchanged.
// - Block size: the wrapper's _wavg_plan, whole warps, as few as spread the
//   columns over the most SMs: income-8's 11,352 columns give blocks of 96
//   threads, 119 of them.
// Either mode sits about 1 us above an empty launch on the H100. Wider
// loads (float4) and the client count as a template parameter were
// measured beside this kernel: float4 bought nothing, the template 0.2-0.35
// us in broadcast mode alone, which no round's device time showed
// (PERF.md, Findings).
#include <cuda_runtime.h>

#define FT_WAVG_MAX_THREADS 256
#define FT_WAVG_UNROLL 8

// BCAST: write the (C, D) broadcast with the carry-over, else the (D,)
// average.
template <bool BCAST>
__global__ void __launch_bounds__(FT_WAVG_MAX_THREADS)
ft_wavg_kernel(const float* __restrict__ x, const float* __restrict__ w,
               int clients, int d, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  // The weight total, reduced by every warp (whole warps: the plan).
  float total = 0.f;
  for (int c = lane; c < clients; c += 32) total += __ldg(w + c);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    total += __shfl_xor_sync(0xffffffffu, total, o);
  const float denom = fmaxf(total, 1e-30f);
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  const float* xc = x + col;
  if (BCAST && !(total > 0.f)) {
    for (int c = 0; c < clients; ++c)
      out[(size_t)c * d + col] = __ldg(xc + (size_t)c * d);
    return;
  }
  float acc = 0.f;
  int c = 0;
  for (; c + FT_WAVG_UNROLL <= clients; c += FT_WAVG_UNROLL) {
    float v[FT_WAVG_UNROLL];
#pragma unroll
    for (int q = 0; q < FT_WAVG_UNROLL; ++q)
      v[q] = __ldg(xc + (size_t)(c + q) * d);
#pragma unroll
    for (int q = 0; q < FT_WAVG_UNROLL; ++q)
      acc = fmaf(__ldg(w + c + q) / denom, v[q], acc);
  }
  for (; c < clients; ++c)
    acc = fmaf(__ldg(w + c) / denom, __ldg(xc + (size_t)c * d), acc);
  for (int c2 = 0; c2 < (BCAST ? clients : 1); ++c2)
    out[(size_t)c2 * d + col] = acc;
}

// x (clients, d), w (clients,); out (d,), or (clients, d) with `broadcast`,
// and not overlapping x. `threads` is the wrapper's plan (_wavg_plan),
// whole warps up to 256. Refuses what does not hold that. Returns the
// cudaError_t of the launch.
extern "C" int ft_weighted_average(const float* x, const float* w,
                                   int clients, int d, int broadcast,
                                   int threads, float* out, void* stream) {
  if (clients < 0 || d < 1 || threads < 32 || threads > FT_WAVG_MAX_THREADS ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((d + threads - 1) / threads));
  const cudaStream_t s = (cudaStream_t)stream;
  if (broadcast)
    ft_wavg_kernel<true><<<grid, threads, 0, s>>>(x, w, clients, d, out);
  else
    ft_wavg_kernel<false><<<grid, threads, 0, s>>>(x, w, clients, d, out);
  return (int)cudaGetLastError();
}
