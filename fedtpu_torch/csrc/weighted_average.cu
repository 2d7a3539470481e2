// K1: FedAvg, the weighted average over the clients axis, in one launch:
// returned as one (D,) row, or written into every client slot with the
// zero-participant carry-over decided on the device (broadcast mode); and
// the same contraction unnormalised (sum mode).
//
// Replaces: fedtpu/ops/pallas_kernels.py::weighted_average_clients
// (_wavg_kernel): sum_c (w_c / max(sum w, 1e-30)) * x_c as one (1,C)@(C,D)
// contraction at Precision.HIGHEST. The broadcast mode also takes in what
// the round does after it (fedtpu/parallel/round.py:874,
// jnp.where(total > 0, bcast(glob), p)): out[c] = the average for every c
// when sum w > 0, else out[c] = x[c].
//
// Element types (template parameters): the client stack x is float32,
// bfloat16 or float16 (ModelConfig.param_dtype); the weights, the weight
// total and the accumulation are float32 whatever it is, as fedtpu reduces
// a 16-bit stack (fedtpu/parallel/round.py:870-871: tensordot of the
// float32 casts). The broadcast mode writes the slot dtype, each average
// rounded once to nearest-even (bcast_global's astype), and the carry-over
// copies x's bits; the (D,) mode writes float32, as the tensordot gives. A
// float32 stack may also be broadcast into 16-bit slots (the round's
// unrounded trained params, fedtpu_torch/training/client.py `wide`): the
// carry-over then writes x rounded, the params the slots would hold.
// NaN and Inf pass through as that arithmetic passes them (0 * Inf is NaN).
//
// Sum mode: out[d] = sum_c w_c * x[c, d] in float32, no normalisation, the
// weights of any sign and any total (a float32 stack only). It is the
// asynchronous tick's discounted arrival sum and its screen's direction
// (fedtpu/parallel/async_fed.py:398-403 and :321-324, psum(tensordot(w,
// delta))), where a poisoned arrival's weight is negative and the total
// may be 0 or less: the (D,) mode's division by max(total, 1e-30) cannot
// be undone there. Same FMA chain in client order from 0, same bounds.
//
// Bound on the card: bytes, with launch latency above them. The (D,) mode
// reads C*D elements + C floats and writes D floats; the broadcast mode
// reads C*D + C and writes C*D elements (income-8, C = 8, D = 11,352, fp32:
// 0.36 / 0.73 MB, 0.12 / 0.22 us at 3.35 TB/s; a 16-bit stack halves the
// element bytes). Its 2*C*D flops are nothing beside that.
//
// Design: one column a thread, one kernel for the three modes (template
// flags), one path for every width and alignment.
// - A 16-bit element is loaded as its 16 bits (__ldg of an unsigned short,
//   neighbouring threads on neighbouring columns) and widened to float32
//   in a register; a store rounds once (__float2bfloat16_rn /
//   __float2half_rn).
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
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#define FT_WAVG_MAX_THREADS 256
#define FT_WAVG_UNROLL 8

// The element types K1 takes: a load widened to float32, a store rounded
// once to nearest-even.
template <typename T>
struct FtElem;

template <>
struct FtElem<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct FtElem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ushort_as_bfloat16(
        __ldg(reinterpret_cast<const unsigned short*>(p))));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <>
struct FtElem<__half> {
  static __device__ __forceinline__ float load(const __half* p) {
    return __half2float(__ushort_as_half(
        __ldg(reinterpret_cast<const unsigned short*>(p))));
  }
  static __device__ __forceinline__ __half store(float v) {
    return __float2half_rn(v);
  }
};

// T: x's element type. BCAST: write the (C, D) broadcast in Out with the
// carry-over, else the (D,) float32 average (Out = float). SUM: the (D,)
// float32 sum, each weight taken as it is (no total, no division).
template <typename T, typename Out, bool BCAST, bool SUM = false>
__global__ void __launch_bounds__(FT_WAVG_MAX_THREADS)
ft_wavg_kernel(const T* __restrict__ x, const float* __restrict__ w,
               int clients, int d, Out* __restrict__ out) {
  static_assert(!(BCAST && SUM), "the sum mode writes one (D,) row");
  const int lane = threadIdx.x & 31;
  // The weight total, reduced by every warp (whole warps: the plan).
  float total = 0.f;
  if constexpr (!SUM) {
    for (int c = lane; c < clients; c += 32) total += __ldg(w + c);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, o);
  }
  const float denom = fmaxf(total, 1e-30f);
  // Client c's coefficient: its normalised weight, or its weight.
  auto coef = [&](int c) {
    if constexpr (SUM)
      return __ldg(w + c);
    else
      return __ldg(w + c) / denom;
  };
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  const T* xc = x + col;
  if constexpr (BCAST) {
    if (!(total > 0.f)) {
      // The carry-over: x's own bits, or x rounded to the slot dtype.
      for (int c = 0; c < clients; ++c) {
        if constexpr (std::is_same<T, Out>::value)
          out[(size_t)c * d + col] = xc[(size_t)c * d];
        else
          out[(size_t)c * d + col] =
              FtElem<Out>::store(FtElem<T>::load(xc + (size_t)c * d));
      }
      return;
    }
  }
  float acc = 0.f;
  int c = 0;
  for (; c + FT_WAVG_UNROLL <= clients; c += FT_WAVG_UNROLL) {
    float v[FT_WAVG_UNROLL];
#pragma unroll
    for (int q = 0; q < FT_WAVG_UNROLL; ++q)
      v[q] = FtElem<T>::load(xc + (size_t)(c + q) * d);
#pragma unroll
    for (int q = 0; q < FT_WAVG_UNROLL; ++q)
      acc = fmaf(coef(c + q), v[q], acc);
  }
  for (; c < clients; ++c)
    acc = fmaf(coef(c), FtElem<T>::load(xc + (size_t)c * d), acc);
  const Out res = FtElem<Out>::store(acc);
  for (int c2 = 0; c2 < (BCAST ? clients : 1); ++c2)
    out[(size_t)c2 * d + col] = res;
}

template <typename T, typename Out, bool BCAST, bool SUM = false>
static void ft_wavg_launch(const void* x, const float* w, int clients, int d,
                           int threads, void* out, cudaStream_t s) {
  const dim3 grid((unsigned)((d + threads - 1) / threads));
  ft_wavg_kernel<T, Out, BCAST, SUM><<<grid, threads, 0, s>>>(
      static_cast<const T*>(x), w, clients, d, static_cast<Out*>(out));
}

// x (clients, d) of `dtype` (0 float32, 1 bfloat16, 2 float16), w
// (clients,) float32. `mode` 0: out (d,) float32, the average (out_dtype
// 0); 1 (broadcast): out (clients, d) of `out_dtype`, which is `dtype` or,
// for a float32 x, a 16-bit one; 2 (sum): out (d,) float32, the
// unnormalised sum of a float32 x. out does not overlap x. `threads` is the
// wrapper's plan (_wavg_plan), whole warps up to 256. Refuses what does not
// hold that. Returns the cudaError_t of the launch.
extern "C" int ft_weighted_average(const void* x, const float* w,
                                   int clients, int d, int dtype,
                                   int out_dtype, int mode, int threads,
                                   void* out, void* stream) {
  const bool broadcast = mode == 1;
  if (clients < 0 || d < 1 || threads < 32 || threads > FT_WAVG_MAX_THREADS ||
      threads % 32 != 0 || dtype < 0 || dtype > 2 || out_dtype < 0 ||
      out_dtype > 2 || mode < 0 || mode > 2 ||
      (!broadcast && out_dtype != 0) ||
      (broadcast && out_dtype != dtype && dtype != 0) ||
      (mode == 2 && dtype != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == 2) {
    ft_wavg_launch<float, float, false, true>(x, w, clients, d, threads, out,
                                              s);
  } else if (!broadcast) {
    if (dtype == 0)
      ft_wavg_launch<float, float, false>(x, w, clients, d, threads, out, s);
    else if (dtype == 1)
      ft_wavg_launch<__nv_bfloat16, float, false>(x, w, clients, d, threads,
                                                  out, s);
    else
      ft_wavg_launch<__half, float, false>(x, w, clients, d, threads, out, s);
  } else if (dtype == 1) {
    ft_wavg_launch<__nv_bfloat16, __nv_bfloat16, true>(x, w, clients, d,
                                                       threads, out, s);
  } else if (dtype == 2) {
    ft_wavg_launch<__half, __half, true>(x, w, clients, d, threads, out, s);
  } else if (out_dtype == 1) {
    ft_wavg_launch<float, __nv_bfloat16, true>(x, w, clients, d, threads,
                                               out, s);
  } else if (out_dtype == 2) {
    ft_wavg_launch<float, __half, true>(x, w, clients, d, threads, out, s);
  } else {
    ft_wavg_launch<float, float, true>(x, w, clients, d, threads, out, s);
  }
  return (int)cudaGetLastError();
}
