// K4: rotate-and-accumulate ring all-reduce over the shards of the clients
// mesh, in one pass.
//
// Replaces: fedtpu/parallel/ring_pallas.py::pallas_ring_all_reduce_sum
// (_ring_kernel). Shard d ends with acc_d = x_d + x_{d-1} + ... + x_{d-S+1}
// (indices mod S), added as a left fold in exactly that order (each shard in
// its own order, as the TPU kernel does), so the result equals the plain
// PyTorch version (torch.roll + add, S-1 times) bit for bit. Built without
// --use_fast_math; the adds are plain fp32 adds nvcc cannot reassociate.
//
// Bound on the card: bytes. It reads S*P floats and writes S*P (8 shards of
// income-32's 11,353 floats: ~0.73 MB, ~0.22 us at 3.35 TB/s); the S-1 adds
// per output are far below the fp32 rate.
//
// Why no ring protocol: on a TPU each shard lives on its own chip and the
// S-1 hops are remote copies between chips. Here every shard lives on the one
// card, so a ring of S-1 dependent hops between thread blocks is pure latency
// (flag handshakes through L2). One ordinary launch reads every shard's
// slice directly instead: the grid runs over the payload columns, each block
// stages the S rows of its column tile in shared memory (each thread its own
// column, read once from device memory) and writes every destination row's
// fold from there. No flags, no cooperative launch, no spin-waits, no
// scratch, and any P (scalar columns: no alignment or padding).
//
// The payload comes from a per-shard pointer table (a kernel parameter). In
// a training gang (fedtpu_torch/parallel/multihost.py) each member holds only
// its own shards' rows, in one exchange buffer allocated here with cudaMalloc
// and exported with cudaIpcGetMemHandle (ft_ipc_alloc); every peer maps it
// once (ft_ipc_open), and the table then mixes local pointers with peers'
// mapped ones. Each member computes only its own destination rows
// (ft_ring_all_reduce_rows), in the same fold order, so its rows equal those
// of the one-process launch over the same (S, P) stack bit for bit. The two
// barriers such a ring needs live on the host, around the launch
// (fedtpu_torch/parallel/ring.py, GangExchange): one before the reads, once
// every member's rows of the round are written; one after them, before any
// member overwrites its rows for the next round. Device-side flags between
// processes that time-slice one card (no MPS) could deadlock, so there are
// none. In one process the output never aliases the input: no barrier.
#include <cuda_runtime.h>
#include <cstring>

#define FT_RING_MAX_SHARDS 64
#define FT_RING_THREADS 128

struct FtRingArgs {
  const float* x[FT_RING_MAX_SHARDS];
  float* acc[FT_RING_MAX_SHARDS];
  long long cols;     // P, floats per shard
  int shards;         // S
  int dst_lo, dst_hi; // the destination rows written: [dst_lo, dst_hi)
};

__global__ void __launch_bounds__(FT_RING_THREADS)
ft_ring_kernel(const FtRingArgs a) {
  __shared__ float tile[FT_RING_MAX_SHARDS][FT_RING_THREADS];
  const int S = a.shards;
  const int t = threadIdx.x;
  const long long col = (long long)blockIdx.x * FT_RING_THREADS + t;
  if (col >= a.cols) return;
  for (int d = 0; d < S; ++d) tile[d][t] = __ldg(a.x[d] + col);
  // Each thread reads back only its own column: no __syncthreads needed.
  for (int d = a.dst_lo; d < a.dst_hi; ++d) {
    float acc = tile[d][t];
    int src = d;
    for (int k = 1; k < S; ++k) {
      src = src == 0 ? S - 1 : src - 1;   // (d - k) mod S
      acc = acc + tile[src][t];
    }
    a.acc[d][col] = acc;
  }
}

// x[d]: shard d's payload of `cols` floats (any alignment), local or
// IPC-mapped; acc[d]: row d of the result, written only for dst_lo <= d <
// dst_hi (one process asks for every row; a gang member for its own), and
// never aliasing any x. One launch of ceil(cols / 128) blocks on `stream`;
// returns its cudaError_t.
extern "C" int ft_ring_all_reduce_rows(const void* const* x, void* const* acc,
                                       int shards, long long cols, int dst_lo,
                                       int dst_hi, void* stream) {
  if (shards < 2 || shards > FT_RING_MAX_SHARDS || cols < 1 || dst_lo < 0 ||
      dst_hi > shards || dst_lo >= dst_hi)
    return (int)cudaErrorInvalidValue;
  FtRingArgs a;
  for (int d = 0; d < shards; ++d) {
    a.x[d] = static_cast<const float*>(x[d]);
    a.acc[d] = d >= dst_lo && d < dst_hi ? static_cast<float*>(acc[d])
                                         : nullptr;
  }
  a.cols = cols;
  a.shards = shards;
  a.dst_lo = dst_lo;
  a.dst_hi = dst_hi;
  const long long blocks = (cols + FT_RING_THREADS - 1) / FT_RING_THREADS;
  ft_ring_kernel<<<(unsigned)blocks, FT_RING_THREADS, 0,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The exchange buffer: `bytes` of zeroed device memory from cudaMalloc (a
// base allocation, so its IPC handle needs no offset; the caching allocator's
// blocks and cudaMallocAsync pools cannot be exported) on the current device,
// and its cudaIpcMemHandle_t (CUDA_IPC_HANDLE_SIZE = 64 bytes) in `handle`.
extern "C" int ft_ipc_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaMalloc(ptr, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(*ptr, 0, (size_t)bytes);
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle((cudaIpcMemHandle_t*)handle, *ptr);
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return (int)err;
}

// A peer's exchange buffer mapped into this process (a process cannot open
// its own handle).
extern "C" int ft_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int ft_ipc_close(void* ptr) {
  return (int)cudaIpcCloseMemHandle(ptr);
}

extern "C" int ft_ipc_free(void* ptr) { return (int)cudaFree(ptr); }
