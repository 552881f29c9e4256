// Timer-wheel bucket scatter + first-occupied-bucket scan (kernel K2).
//
// Replaces the TPU kernel dmclock_tpu/engine/kernels_pallas.py:59
// (_wheel_kernel, called through wheel_scan_pallas), which split every
// int64 key into a signed high and a biased low int32 word and made two
// one-hot passes over VMEM rows, because that stack had no 64-bit
// compare in its vector unit and no scatter.  Hopper has both, so this
// kernel computes the function directly:
//
//   cnt[b]  = #{i : slot[i] == b}                       (int32[nb])
//   bmin[b] = min{keys[i] : slot[i] == b}, KEY_INF if none (int64[nb])
//   b0      = the first b with cnt[b] > 0 (nb if none)
//   val     = bmin[b0] (KEY_INF if none), found = b0 < nb
//
// A lane with slot outside [0, nb) -- the callers use slot == nb -- is
// masked out.
//
// Bound: it reads N*(8 + 4) bytes (1.2 MB at N = 100,000, about 0.36 us
// at 3.35 TB/s) and writes 12*nb + 9 bytes.  At the calendar's shapes
// that is below the cost of one launch, so what a call costs is its
// launches and its serial tail.  The design keeps both to the least:
// - One launch per call, nothing around it.  Blocks merge into a
//   persistent workspace (kMaxBuckets + 1 int32 counts, the last word
//   the block ticket, and kMaxBuckets int64 minima) that is clean
//   between calls: counts 0, minima KEY_INF, ticket 0.  The wrapper
//   fills it once per device; every call leaves it so, since the last
//   block resets the nb buckets it used.  So the outputs need no
//   pre-fill, and calls on one device must be ordered (one stream).
// - Stop packs pile into a few buckets (class bits at bit 58, bucket
//   shift 52), so most lanes of a warp share a bucket.  The lanes are
//   grouped by bucket with __match_any_sync; each group's lowest lane
//   adds the group's size and, only if it lowers the bucket's shared
//   minimum, issues one signed atomicMin of the group's minimum (taken
//   with two 32-bit warp reductions: signed high word, then unsigned low
//   word among the lanes that hold the least high word).  So a warp
//   issues one shared atomic per distinct bucket, not one per lane.
// - The serial tail is a chain of memory round trips, so each is cut to
//   one: a lane loads its slot and key together (the key load does not
//   wait on the slot); the block's merge atomics need no fence of their
//   own, because thread 0 draws the block ticket with one acq_rel atomic
//   after a barrier; the last block (the one that draws gridDim.x - 1)
//   copies the merged buckets into the outputs and its own shared
//   memory, resets the workspace, and finds the first occupied bucket
//   from shared memory.
// - The min is SIGNED: entry keys can be negative, and the unsigned
//   overload would order them wrongly.  Integer add and min are
//   commutative and associative, so every run gives the plain version's
//   result bit for bit, whatever the order of the atomics.
//
// Plain C interface, loaded with ctypes (dmclock_tpu_torch/engine/_ext.py).

#include <cstdint>
#include <cuda_runtime.h>

#include <cuda/atomic>

namespace {

constexpr long long kKeyInf = 0x7fffffffffffffffLL;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuckets = 2048;   // 24 KB of shared memory per block

__global__ void __launch_bounds__(kThreads)
wheel_scan_kernel(const long long* __restrict__ keys,
                  const int32_t* __restrict__ slot, int n, int nb,
                  int* __restrict__ ws_cnt, long long* __restrict__ ws_min,
                  int* __restrict__ cnt, long long* __restrict__ bmin,
                  long long* __restrict__ val, bool* __restrict__ found) {
  extern __shared__ long long smem[];
  long long* s_min = smem;
  int* s_cnt = reinterpret_cast<int*>(smem + nb);
  __shared__ bool s_last;
  __shared__ int s_first[kWarps];
  const unsigned lane = threadIdx.x % 32;

  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    s_min[b] = kKeyInf;
    s_cnt[b] = 0;
  }
  __syncthreads();

  // grid-stride over whole warps, so every lane takes part in the warp
  // collectives; lanes past n or masked out carry the group id ~0u
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x + threadIdx.x - lane; base < n;
       base += stride) {
    const int i = base + lane;
    unsigned s = ~0u;
    long long k = kKeyInf;
    if (i < n) {   // both loads issue at once: the key does not wait
      const unsigned si = static_cast<unsigned>(__ldg(slot + i));
      const long long ki = __ldg(keys + i);
      if (si < static_cast<unsigned>(nb)) {
        s = si;
        k = ki;
      }
    }
    const unsigned group = __match_any_sync(0xffffffffu, s);
    const int hi = static_cast<int>(k >> 32);
    const unsigned lo = static_cast<unsigned>(k);
    const int mhi = __reduce_min_sync(group, hi);
    const unsigned mlo = __reduce_min_sync(group, hi == mhi ? lo : ~0u);
    if (s != ~0u && lane == static_cast<unsigned>(__ffs(group) - 1)) {
      const long long m = static_cast<long long>(
          (static_cast<unsigned long long>(static_cast<unsigned>(mhi))
           << 32) | mlo);
      atomicAdd(&s_cnt[s], __popc(group));
      if (m < s_min[s]) atomicMin(&s_min[s], m);
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int c = s_cnt[b];
    if (c != 0) {
      atomicAdd(&ws_cnt[b], c);
      atomicMin(&ws_min[b], s_min[b]);
    }
  }
  // the ticket: the barrier orders the block's merges before thread 0's
  // release, and the last block's acquire (then its barrier) orders
  // every block's merges before its reads
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(
        *reinterpret_cast<unsigned*>(ws_cnt + kMaxBuckets));
    s_last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) ==
             gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every merge is visible.  __ldcg reads L2, where the
  // other blocks' atomics landed.  Copy out, reset, and note each
  // thread's first occupied bucket (its buckets ascend).
  int first = nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int c = __ldcg(&ws_cnt[b]);
    const long long m = __ldcg(&ws_min[b]);
    cnt[b] = c;
    bmin[b] = m;
    s_min[b] = m;
    ws_cnt[b] = 0;
    ws_min[b] = kKeyInf;
    if (c > 0 && first == nb) first = b;
  }
  first = __reduce_min_sync(0xffffffffu, first);
  if (lane == 0) s_first[threadIdx.x / 32] = first;
  __syncthreads();
  if (threadIdx.x == 0) {
    int b0 = nb;
    for (int w = 0; w < kWarps; ++w) b0 = min(b0, s_first[w]);
    *found = b0 < nb;
    *val = b0 < nb ? s_min[b0] : kKeyInf;
    ws_cnt[kMaxBuckets] = 0;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a bucket count outside (0, kMaxBuckets] or a
// negative n.  `ws_cnt` (kMaxBuckets + 1 int32) and `ws_min`
// (kMaxBuckets int64) are the clean workspace, left clean; `cnt` (nb
// int32), `bmin` (nb int64), `val` (int64) and `found` (bool) are written
// whole.
extern "C" int wheel_scan_launch(const void* keys, const void* slot,
                                 void* ws_cnt, void* ws_min, void* cnt,
                                 void* bmin, void* val, void* found, int n,
                                 int nb, void* stream) {
  if (nb <= 0 || nb > kMaxBuckets || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2 * sms) blocks = 2 * sms;
  if (blocks < 1) blocks = 1;
  const size_t shmem = static_cast<size_t>(nb) * (sizeof(long long) +
                                                  sizeof(int));
  wheel_scan_kernel<<<blocks, kThreads, shmem, (cudaStream_t)stream>>>(
      static_cast<const long long*>(keys),
      static_cast<const int32_t*>(slot), n, nb, static_cast<int*>(ws_cnt),
      static_cast<long long*>(ws_min), static_cast<int*>(cnt),
      static_cast<long long*>(bmin), static_cast<long long*>(val),
      static_cast<bool*>(found));
  return static_cast<int>(cudaGetLastError());
}
