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
// The payload comes from a per-shard pointer table (a kernel parameter), so
// peer pointers of other cards can take the place of the local ones later. A
// ring across cards would then also need a barrier before the reads and
// another before any shard overwrites its x; this kernel has neither, since
// its output never aliases its input on one card.
#include <cuda_runtime.h>

#define FT_RING_MAX_SHARDS 64
#define FT_RING_THREADS 128

struct FtRingArgs {
  const float* x[FT_RING_MAX_SHARDS];
  float* acc[FT_RING_MAX_SHARDS];
  long long cols;     // P, floats per shard
  int shards;         // S
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
  for (int d = 0; d < S; ++d) {
    float acc = tile[d][t];
    int src = d;
    for (int k = 1; k < S; ++k) {
      src = src == 0 ? S - 1 : src - 1;   // (d - k) mod S
      acc = acc + tile[src][t];
    }
    a.acc[d][col] = acc;
  }
}

// x[d], acc[d]: shard d's payload of `cols` floats (any alignment); acc must
// not alias x. One launch of ceil(cols / 128) blocks on `stream`; returns its
// cudaError_t.
extern "C" int ft_ring_all_reduce(const void* const* x, void* const* acc,
                                  int shards, long long cols, void* stream) {
  if (shards < 2 || shards > FT_RING_MAX_SHARDS || cols < 1)
    return (int)cudaErrorInvalidValue;
  FtRingArgs a;
  for (int d = 0; d < shards; ++d) {
    a.x[d] = static_cast<const float*>(x[d]);
    a.acc[d] = static_cast<float*>(acc[d]);
  }
  a.cols = cols;
  a.shards = shards;
  const long long blocks = (cols + FT_RING_THREADS - 1) / FT_RING_THREADS;
  ft_ring_kernel<<<(unsigned)blocks, FT_RING_THREADS, 0,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
