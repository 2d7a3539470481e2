// Device-side pieces of the eval kernels: the Linear -> ReLU -> ... ->
// Linear stack of one model over a tile of rows, register-tiled, in two
// forms that give the same bits:
// - resident (ft_mlp_tile_forward_regs: K2 eval_confusion.cu, K3
//   mlp_forward.cu): the whole model sits in shared memory, staged with
//   ft_stage_begin / ft_stage_end;
// - streamed (ft_mlp_tile_forward_streamed: K2 and K3 when one model does
//   not fit in a block): the weights pass through two shared buffers, a
//   chunk of input rows of one layer at a time.
// K5 (fused_round.cu) runs its own tiles in the same FMA order, and stages
// with the bulk-copy pieces of the streamed path (ft_chunk_issue,
// ft_bar_wait).
//
// Flat parameter layout (fedtpu_torch/models/mlp.py): for each layer, w as
// (in, out) row-major, then b (out).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// The most Linear layers a kernel takes on the card: MlpDims is a by-value
// kernel parameter, and at 64 layers K3 ran slower (PERF.md), so 16.
#define FT_MAX_LAYERS 16
#define FT_THREADS 256

struct MlpDims {
  int n_layers;                  // number of Linear layers
  int dims[FT_MAX_LAYERS + 1];   // (input_dim, *hidden_sizes, num_classes)
};

// Register-tiled forward.
//
// Each output is a sequential fp32 FMA chain over the inputs from i = 0 up,
// starting at 0, then + bias, then ReLU on hidden layers (NaN passes through
// ReLU, as torch.relu). So K2's and K3's logits of the same rows are bit
// for bit equal, whatever tile either runs. The schedule: each thread owns a
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

// Staging of one model's parameters and one x tile into shared memory, for
// a block that then runs ft_mlp_tile_forward_regs on the tile.
//
// Layout at `smem` (16-byte aligned): a 4-float header (the mbarrier), then
// ft_round4(count + 3) floats that hold the `count` parameters, placed so
// that their 16-byte aligned middle lies on a 16-byte boundary as it does
// in global memory. The 16-byte aligned middle comes in with one bulk
// asynchronous copy (cp.async.bulk, completion on the mbarrier), the head
// and tail that are not 16-byte aligned with plain loads, the x tile with
// cp.async (4 bytes each: its rows may have any alignment). No thread
// spends registers on the bulk of the copy.
// Floats the staging layout takes ahead of whatever follows it (the x
// tile): the header and the parameters with their alignment slack.
__host__ __device__ __forceinline__ int ft_stage_floats(int count) {
  return 4 + ft_round4(count + 3);
}

__device__ __forceinline__ uint32_t ft_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

struct FtStage {
  float* p;    // the parameters in shared memory
  bool bulk;   // a bulk copy is in flight on the mbarrier
};

// Issues the copies; every thread of the block must call it, then
// ft_stage_end. Between the two the block may write other shared memory.
__device__ __forceinline__ FtStage ft_stage_begin(float* smem,
                                                  const float* src, int count,
                                                  float* xt, const float* xg,
                                                  int xcount) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int head = min(count, (int)((16 - ((uintptr_t)src & 15)) & 15) / 4);
  const int bulk = (count - head) & ~3;
  float* p = smem + 4 + ((4 - head) & 3);
  if (threadIdx.x == 0 && bulk > 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     ft_smem_addr(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(ft_smem_addr(bar)),
                 "r"(bulk * 4)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(ft_smem_addr(p + head)),
        "l"(src + head), "r"(bulk * 4), "r"(ft_smem_addr(bar))
        : "memory");
  }
  for (int i = threadIdx.x; i < xcount; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     ft_smem_addr(xt + i)),
                 "l"(xg + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = threadIdx.x; i < head; i += blockDim.x) p[i] = src[i];
  for (int i = head + bulk + threadIdx.x; i < count; i += blockDim.x)
    p[i] = src[i];
  return {p, bulk > 0};
}

// Waits for ft_stage_begin's copies. On return the parameters, the x tile
// and whatever the block wrote to shared memory in between are visible to
// the whole block. The __syncthreads() also puts the mbarrier's init before
// any thread's wait on it, which the wait needs.
__device__ __forceinline__ void ft_stage_end(float* smem, const FtStage& st) {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (st.bulk) {
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred r;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 r, [%1], 0;\n"
          " selp.u32 %0, 1, 0, r;\n}\n"
          : "=r"(done)
          : "r"(ft_smem_addr(smem))
          : "memory");
  }
}

// ---------------------------------------------------------------- streamed
// A model whose parameters do not fit in one block's shared memory streams
// its weights, layer by layer, through two shared buffers of `cap` floats:
// a chunk is a run of whole input rows of W (in, out) row-major, so it is
// one contiguous range of global memory and comes in with one
// cp.async.bulk on its buffer's mbarrier (the unaligned head and tail, at
// most 3 floats each, with plain loads). While a chunk is used, the next is
// in flight. Each output keeps its running sum in the output activation tile
// between chunks: it is still one sequential fp32 FMA chain over i from 0,
// then + b, then ReLU (storing and reloading an fp32 value is exact), so the
// streamed forward gives the resident forward's bits.
//
// Shared layout at `smem` (16-byte aligned): a 4-float header (the two
// mbarriers), then the two buffers; what follows them (the x tile, the
// activation tiles) is the caller's.
__host__ __device__ __forceinline__ int ft_stream_floats(int cap) {
  return 4 + 2 * cap;
}

// Input rows of a layer `out` wide in one chunk of a `cap`-float buffer (a
// chunk may sit up to 3 floats into its buffer, for alignment).
__host__ __device__ __forceinline__ int ft_chunk_rows(int in, int out,
                                                      int cap) {
  return min(in, (cap - 3) / out);
}

// Where a chunk that starts at global `src` lies in its buffer: placed so
// that its 16-byte aligned middle falls on a 16-byte boundary, as in global
// memory (the bulk copy needs both ends aligned).
__device__ __forceinline__ float* ft_chunk_at(float* buf, const float* src) {
  const int head = (int)((16 - ((uintptr_t)src & 15)) & 15) / 4;
  return buf + ((4 - head) & 3);
}

// Issues the copy of `count` floats at `src` into `buf`; every thread of the
// block calls it. Completion: the mbarrier's phase for the bulk part, the
// next __syncthreads() for the head and tail.
__device__ __forceinline__ void ft_chunk_issue(uint64_t* bar, float* buf,
                                               const float* src, int count) {
  const int head = min(count, (int)((16 - ((uintptr_t)src & 15)) & 15) / 4);
  const int bulk = (count - head) & ~3;
  float* p = ft_chunk_at(buf, src);
  if (threadIdx.x == 0) {
    // The buffer was last read through the generic proxy (ordered before
    // this by the caller's __syncthreads()); the bulk copy writes it through
    // the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (bulk > 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              ft_smem_addr(bar)),
          "r"(bulk * 4)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(ft_smem_addr(p + head)),
          "l"(src + head), "r"(bulk * 4), "r"(ft_smem_addr(bar))
          : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       ft_smem_addr(bar))
                   : "memory");
    }
  }
  for (int i = threadIdx.x; i < head; i += blockDim.x) p[i] = src[i];
  for (int i = head + bulk + threadIdx.x; i < count; i += blockDim.x)
    p[i] = src[i];
}

__device__ __forceinline__ void ft_bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred r;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 r, [%1], %2;\n"
        " selp.u32 %0, 1, 0, r;\n}\n"
        : "=r"(done)
        : "r"(ft_smem_addr(bar)), "r"(parity)
        : "memory");
}

// One chunk of one layer, register-tiled as ft_layer_microtiled: inputs
// i0 <= i < i1 of every output, the chunk's weights at wc (row i0 first).
// The first chunk starts each sum at 0, the others at the value the tile
// holds; the last adds b (global memory) and applies the ReLU.
template <int TR, int TJ>
__device__ __forceinline__ void ft_layer_chunk(const float* h, int ldh, int i0,
                                               int i1, const float* wc,
                                               const float* __restrict__ b,
                                               int out, bool relu, int rows,
                                               float* o, int ldo, bool first,
                                               bool last) {
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
      for (int q = 0; q < TJ; ++q) acc[a][q] = first ? 0.f : o[r[a] * ldo + j[q]];
#pragma unroll 8
    for (int i = i0; i < i1; ++i) {
      float hv[TR], wv[TJ];
#pragma unroll
      for (int a = 0; a < TR; ++a) hv[a] = h[r[a] * ldh + i];
#pragma unroll
      for (int q = 0; q < TJ; ++q) wv[q] = wc[(i - i0) * out + j[q]];
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
        float v = acc[a][q];
        if (last) {
          v += b[j[q]];
          if (relu && v < 0.f) v = 0.f;
        }
        o[r[a] * ldo + j[q]] = v;
      }
    }
  }
}

// The tile choice of ft_layer_regs.
__device__ __forceinline__ void ft_layer_chunk_regs(
    const float* h, int ldh, int i0, int i1, const float* wc, const float* b,
    int out, bool relu, int rows, float* o, int ldo, bool first, bool last) {
  const int threads = blockDim.x;
  if (((rows + 3) / 4) * ((out + 3) / 4) >= threads)
    ft_layer_chunk<4, 4>(h, ldh, i0, i1, wc, b, out, relu, rows, o, ldo, first,
                         last);
  else if (((rows + 1) / 2) * ((out + 1) / 2) >= threads)
    ft_layer_chunk<2, 2>(h, ldh, i0, i1, wc, b, out, relu, rows, o, ldo, first,
                         last);
  else
    ft_layer_chunk<1, 1>(h, ldh, i0, i1, wc, b, out, relu, rows, o, ldo, first,
                         last);
}

// Starts a streamed forward: initialises the two mbarriers and issues the
// first chunk (layer 0's first input rows) and the x tile (cp.async, as
// ft_stage_begin). Every thread calls it, then ft_stage_end(smem, {p, false})
// or any wait that ends in __syncthreads(), then
// ft_mlp_tile_forward_streamed.
__device__ __forceinline__ void ft_stream_begin(float* smem,
                                                const float* params,
                                                const MlpDims& md, int cap,
                                                float* xt, const float* xg,
                                                int xcount) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       ft_smem_addr(bars + i))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int out = md.dims[1];
  ft_chunk_issue(bars, smem + 4, params,
                 ft_chunk_rows(md.dims[0], out, cap) * out);
  for (int i = threadIdx.x; i < xcount; i += blockDim.x)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     ft_smem_addr(xt + i)),
                 "l"(xg + i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The forward of `rows` rows of x (shared memory, stride dims[0]) through
// the model at global `params`, streamed (see above) after ft_stream_begin;
// act0 and act1 as for ft_mlp_tile_forward_regs. Returns the buffer that
// holds the logits, visible to the whole block.
__device__ __forceinline__ const float* ft_mlp_tile_forward_streamed(
    float* smem, const float* __restrict__ params, const MlpDims& md, int cap,
    int rows, const float* x, float* act0, float* act1) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* bufs[2] = {smem + 4, smem + 4 + cap};
  const float* cur = x;
  int ldc = md.dims[0];
  float* nxt = act0;
  int off = 0;
  int n = 0;  // chunks issued before this one, over all layers
  for (int l = 0; l < md.n_layers; ++l) {
    const int in = md.dims[l];
    const int out = md.dims[l + 1];
    const float* w = params + off;
    const float* b = w + in * out;
    const int ldo = ft_act_stride(out);
    const int ci = ft_chunk_rows(in, out, cap);
    for (int i0 = 0; i0 < in; i0 += ci, ++n) {
      const int i1 = min(in, i0 + ci);
      // The next chunk: the rest of this layer, or the next layer's first.
      if (i1 < in) {
        ft_chunk_issue(bars + ((n + 1) & 1), bufs[(n + 1) & 1],
                       w + (size_t)i1 * out, (min(in, i1 + ci) - i1) * out);
      } else if (l + 1 < md.n_layers) {
        const int out2 = md.dims[l + 2];
        ft_chunk_issue(bars + ((n + 1) & 1), bufs[(n + 1) & 1], b + out,
                       ft_chunk_rows(out, out2, cap) * out2);
      }
      ft_bar_wait(bars + (n & 1), (n >> 1) & 1);
      ft_layer_chunk_regs(cur, ldc, i0, i1,
                          ft_chunk_at(bufs[n & 1], w + (size_t)i0 * out), b,
                          out, l < md.n_layers - 1, rows, nxt, ldo, i0 == 0,
                          i1 == in);
      __syncthreads();
    }
    off += in * out + out;
    cur = nxt;
    ldc = ldo;
    nxt = nxt == act0 ? act1 : act0;
  }
  return cur;
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
