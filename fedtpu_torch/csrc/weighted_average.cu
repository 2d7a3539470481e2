// K1: weighted average over the clients axis (FedAvg).
//
// Replaces: fedtpu/ops/pallas_kernels.py::weighted_average_clients
// (_wavg_kernel): sum_c (w_c / max(sum w, 1e-30)) * x_c as one (1,C)@(C,D)
// contraction at Precision.HIGHEST.
//
// Bound on the card: bytes. It reads C*D + C floats and writes D (income-8:
// 8 * 11,352 params, ~0.4 MB, ~0.12 us at 3.35 TB/s) and does 2*C*D flops;
// launch latency dominates at this size.
//
// Design: one thread per output column, so neighbouring threads read
// neighbouring addresses of every client row (coalesced) and each input is
// read once. Each block normalises the C weights into shared memory exactly
// as the Pallas function does (w_c / max(sum w, 1e-30), in fp32), and each
// thread accumulates over C with fp32 FMA: full fp32, no TF32. The broadcast
// back into the C client slots is left to the caller (one copy_).
#include <cuda_runtime.h>

#define FT_WAVG_THREADS 256

__global__ void ft_weighted_average_kernel(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           int clients, int d,
                                           float* __restrict__ out) {
  extern __shared__ float wn[];   // clients normalised weights, then the total
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int c = 0; c < clients; ++c) total += w[c];
    wn[clients] = fmaxf(total, 1e-30f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < clients; c += blockDim.x)
    wn[c] = w[c] / wn[clients];
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float acc = 0.f;
  for (int c = 0; c < clients; ++c)
    acc = fmaf(wn[c], x[(size_t)c * d + j], acc);
  out[j] = acc;
}

// x (clients, d), w (clients,), out (d,). Returns the cudaError_t of the
// launch.
extern "C" int ft_weighted_average(const float* x, const float* w, int clients,
                                   int d, float* out, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)clients + 1);
  const dim3 grid((d + FT_WAVG_THREADS - 1) / FT_WAVG_THREADS);
  ft_weighted_average_kernel<<<grid, FT_WAVG_THREADS, smem,
                               (cudaStream_t)stream>>>(x, w, clients, d, out);
  return (int)cudaGetLastError();
}
