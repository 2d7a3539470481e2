// K4: rotate-and-accumulate ring all-reduce over the shards of the clients
// mesh.
//
// Replaces: fedtpu/parallel/ring_pallas.py::pallas_ring_all_reduce_sum
// (_ring_kernel, _residual_credits). Shard d ends with
// acc_d = x_d + x_{d-1} + ... + x_{d-S+1}, added in exactly that order (each
// shard in its own order, as the TPU kernel does), so the result equals the
// plain PyTorch version (torch.roll + add, S-1 times) bit for bit. Built
// without --use_fast_math; the adds are plain fp32 adds nvcc cannot
// reassociate.
//
// Bound on the card: bytes. It reads S*P floats and writes S*P (8 shards of
// income-32's 11,353 floats: ~0.73 MB, ~0.22 us at 3.35 TB/s). What it
// really pays for is S-1 dependent hops, each a flag handshake through L2
// between blocks, so its time is latency: at this size, microseconds per hop.
//
// Design: one cooperative launch per all-reduce, grid S x B. Block (d, s)
// owns slice s of shard d's payload (float4 accesses), with its own two
// communication slots and its own counters in an int32 flag buffer, so the
// B slices of a shard run their rings independently. At hop k it copies what
// arrived last hop (its own x at hop 0) into the right neighbour's slot
// (k+1)%2 -- the TPU kernel's make_async_remote_copy -- releases the
// neighbour's receive flag, waits (acquire) on its own, and adds its slot
// (k+1)%2 into acc. Synchronisation follows ring_pallas.py:74-113: a start
// barrier with both neighbours, one capacity credit per hop to the left
// neighbour once a slot has been read out, and the residual credits drained
// at the end, so every flag ends the launch at zero and the next launch
// needs no memset.
//
// One repair of the TPU protocol: its hop-0 credit (slot 0, read at hop 0
// from its own x) makes the first wait on slot 0 (hop 3) pass one credit
// early, before the right neighbour has read out what hop 1 wrote there.
// Here the hop-0 send reads x directly and that credit stands for the whole
// launch: a wait on slot 0 needs two credits and takes one. The counts
// consumed, and so the residuals drained, are the TPU kernel's.
//
// The payload comes from a per-shard pointer table (kernel parameters), so
// peer pointers of other cards can replace the local ones later. Every
// spin-wait is bounded by a clock64() budget; on timeout the block records
// an error word that the wrapper reads and raises on, and every other block
// stops at its next wait. Only thread 0 of a block touches the flags, with
// __syncthreads() on both sides; slot data moves through L2 (__ldcg/__stcg).
#include <cuda/atomic>
#include <cuda_runtime.h>

#define FT_RING_MAX_SHARDS 64
#define FT_RING_THREADS 256

// Flag words of one (shard, slice) block.
enum { FT_BAR = 0, FT_RECV = 1, FT_CAP = 3, FT_FLAGS = 5 };
// Kinds of wait, in the error word's top byte.
enum { FT_WAIT_BARRIER = 1, FT_WAIT_CAPACITY = 2, FT_WAIT_RECEIVE = 3,
       FT_WAIT_DRAIN = 4 };

struct FtRingArgs {
  const float* x[FT_RING_MAX_SHARDS];
  float* acc[FT_RING_MAX_SHARDS];
  float4* comm;       // (S, B, 2, slice) float4
  int* flags;         // (S, B, FT_FLAGS)
  int* err;           // 0, or (kind << 24) | (block + 1) of the first timeout
  int shards, blocks_per_shard, vecs, slice;
  int residual[2];    // _residual_credits(S)
  long long budget;   // clock64() cycles per wait
  int fault;          // > 0: block (0, 0) skips its receive signal at hop fault-1
};

using ft_flag = cuda::atomic_ref<int, cuda::thread_scope_device>;

__device__ __forceinline__ void ft_signal(int* word) {
  ft_flag(*word).fetch_add(1, cuda::memory_order_release);
}

// Waits until *word >= need, then takes `take` from it. False when the
// budget ran out (the error word then names this wait) or another block
// failed first.
__device__ bool ft_wait(int* word, int need, int take, int* err, int code,
                        long long budget) {
  ft_flag f(*word);
  ft_flag e(*err);
  const long long t0 = clock64();
  while (f.load(cuda::memory_order_acquire) < need) {
    if (e.load(cuda::memory_order_relaxed) != 0) return false;
    if (clock64() - t0 > budget) {
      int none = 0;
      e.compare_exchange_strong(none, code, cuda::memory_order_relaxed);
      return false;
    }
  }
  if (take) f.fetch_sub(take, cuda::memory_order_relaxed);
  return true;
}

__global__ void __launch_bounds__(FT_RING_THREADS)
ft_ring_kernel(const FtRingArgs a) {
  const int S = a.shards, B = a.blocks_per_shard;
  const int d = blockIdx.x / B, s = blockIdx.x % B;
  const int right = (d + 1) % S, left = (d + S - 1) % S;
  const int lo = s * a.slice;
  const int n = max(0, min(a.vecs - lo, a.slice));
  int* mine = a.flags + (size_t)(d * B + s) * FT_FLAGS;
  int* rflags = a.flags + (size_t)(right * B + s) * FT_FLAGS;
  int* lflags = a.flags + (size_t)(left * B + s) * FT_FLAGS;
  const float4* x = reinterpret_cast<const float4*>(a.x[d]) + lo;
  float4* acc = reinterpret_cast<float4*>(a.acc[d]) + lo;
  auto slot = [&](int shard, int p) {
    return a.comm + ((size_t)(shard * B + s) * 2 + p) * a.slice;
  };
  const bool lead = threadIdx.x == 0;
  const int who = blockIdx.x + 1;
  __shared__ int ok;

  // Start barrier: both neighbours are live before any copy lands.
  if (lead) {
    ft_signal(lflags + FT_BAR);
    ft_signal(rflags + FT_BAR);
    ok = ft_wait(mine + FT_BAR, 2, 2, a.err, (FT_WAIT_BARRIER << 24) | who,
                 a.budget);
  }
  __syncthreads();
  if (!ok) return;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc[i] = x[i];

  for (int step = 0; step < S - 1; ++step) {
    const int send = step & 1, recv = send ^ 1;
    if (step >= 2) {
      // The right neighbour's slot `recv` was written at step-2: wait for
      // its credit that it has been added and forwarded (slot 0 keeps the
      // standing hop-0 credit, see the header).
      if (lead)
        ok = ft_wait(mine + FT_CAP + recv, recv == 0 ? 2 : 1, 1, a.err,
                     (FT_WAIT_CAPACITY << 24) | who, a.budget);
      __syncthreads();
      if (!ok) return;
    }
    float4* dst = slot(right, recv);
    const float4* src = slot(d, send);
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      __stcg(dst + i, step == 0 ? x[i] : __ldcg(src + i));
    __threadfence();
    __syncthreads();
    if (lead) {
      if (!(a.fault == step + 1 && blockIdx.x == 0))
        ft_signal(rflags + FT_RECV + recv);
      ok = ft_wait(mine + FT_RECV + recv, 1, 1, a.err,
                   (FT_WAIT_RECEIVE << 24) | who, a.budget);
    }
    __syncthreads();
    if (!ok) return;
    const float4* in = slot(d, recv);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float4 v = __ldcg(in + i);
      float4 t = acc[i];
      t.x = t.x + v.x;
      t.y = t.y + v.y;
      t.z = t.z + v.z;
      t.w = t.w + v.w;
      acc[i] = t;
    }
    __syncthreads();
    // Our slot `send` has been read out by this hop's copy: credit the
    // left neighbour, who writes it.
    if (lead) ft_signal(lflags + FT_CAP + send);
  }

  // Drain the credits no wait consumed, so every flag ends at zero.
  if (lead) {
    for (int p = 0; p < 2; ++p)
      if (a.residual[p] &&
          !ft_wait(mine + FT_CAP + p, a.residual[p], a.residual[p], a.err,
                   (FT_WAIT_DRAIN << 24) | who, a.budget))
        return;
  }
}

// Co-resident blocks of ft_ring_kernel on the current device (0 when it
// cannot launch cooperatively). Returns the cudaError_t of the queries.
extern "C" int ft_ring_max_blocks(int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ft_ring_kernel,
                                                FT_RING_THREADS, 0);
  *out = coop ? per_sm * sms : 0;
  return (int)cudaGetLastError();
}

// x[d], acc[d]: shard d's payload of vecs float4 (16-byte aligned). comm:
// shards * blocks_per_shard * 2 * slice float4; flags: shards *
// blocks_per_shard * 5 int32, all zero; err: one int32, zero. One
// cooperative launch of shards * blocks_per_shard blocks on `stream`;
// returns its cudaError_t (cudaErrorCooperativeLaunchTooLarge when the grid
// cannot be co-resident).
extern "C" int ft_ring_all_reduce(const void* const* x, void* const* acc,
                                  int shards, int blocks_per_shard, int vecs,
                                  int slice, void* comm, void* flags,
                                  void* err, int residual0, int residual1,
                                  long long budget, int fault, void* stream) {
  if (shards < 2 || shards > FT_RING_MAX_SHARDS || blocks_per_shard < 1)
    return (int)cudaErrorInvalidValue;
  FtRingArgs a;
  for (int d = 0; d < shards; ++d) {
    a.x[d] = static_cast<const float*>(x[d]);
    a.acc[d] = static_cast<float*>(acc[d]);
  }
  a.comm = static_cast<float4*>(comm);
  a.flags = static_cast<int*>(flags);
  a.err = static_cast<int*>(err);
  a.shards = shards;
  a.blocks_per_shard = blocks_per_shard;
  a.vecs = vecs;
  a.slice = slice;
  a.residual[0] = residual0;
  a.residual[1] = residual1;
  a.budget = budget;
  a.fault = fault;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)ft_ring_kernel, dim3(shards * blocks_per_shard),
      dim3(FT_RING_THREADS), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so later launches are not blamed
    return (int)e;
  }
  return (int)cudaGetLastError();
}
