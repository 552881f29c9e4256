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
// Design (simple and right first):
// - Each block keeps cnt[nb] (int32) and bmin[nb] (int64) in shared
//   memory (12*nb bytes: 9 KB at nb = 768), walks its grid-stride lanes
//   and does shared atomicAdd / atomicMin.  Then it merges its non-empty
//   buckets into the global cnt / bmin with global atomics.  The wrapper
//   pre-fills those as 0 and KEY_INF.
// - The scan for the first occupied bucket runs in the LAST block to
//   finish, found with a ticket: every block fences its merge
//   (__threadfence) and takes a ticket from an atomic counter; the block
//   that draws gridDim.x - 1 sees every merge and scans.  One launch
//   instead of a second one-block launch, and the scan reads buckets that
//   are still in L2.  The ticket word is cnt[nb], zeroed by the wrapper
//   with the counts, so no state survives a call.
// - The min is SIGNED: atomicMin(long long*, long long).  Entry keys can
//   be negative, and the unsigned overload would order them wrongly.
// - Exactness does not depend on the order of the atomics: integer add
//   and integer min are commutative and associative, so every run gives
//   the plain version's result bit for bit.
//
// Bound: it reads N*(8 + 4) bytes (1.2 MB at N = 100,000, about 0.36 us
// at 3.35 TB/s) and writes 12*nb + 9 bytes, so at the calendar's shapes
// it is launch-latency bound.  Stop packs pile into a few buckets (class
// bits at bit 58, bucket shift 52), so most lanes of a block hit the same
// shared counters; that costs time, not correctness.  Warp-aggregated
// atomics are the next step.
//
// Plain C interface, loaded with ctypes (dmclock_tpu_torch/engine/_ext.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kKeyInf = 0x7fffffffffffffffLL;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuckets = 2048;   // 24 KB of shared memory per block

__global__ void __launch_bounds__(kThreads)
wheel_scan_kernel(const long long* __restrict__ keys,
                  const int32_t* __restrict__ slot, int n, int nb,
                  int* __restrict__ cnt, long long* __restrict__ bmin,
                  long long* __restrict__ val, bool* __restrict__ found) {
  extern __shared__ long long smem[];
  long long* s_min = smem;
  int* s_cnt = reinterpret_cast<int*>(smem + nb);
  __shared__ bool s_last;
  __shared__ int s_first[kWarps];

  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    s_min[b] = kKeyInf;
    s_cnt[b] = 0;
  }
  __syncthreads();

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned s = static_cast<unsigned>(slot[i]);
    if (s < static_cast<unsigned>(nb)) {
      atomicAdd(&s_cnt[s], 1);
      atomicMin(&s_min[s], keys[i]);
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int c = s_cnt[b];
    if (c != 0) {
      atomicAdd(&cnt[b], c);
      atomicMin(&bmin[b], s_min[b]);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* ticket = reinterpret_cast<unsigned*>(cnt + nb);
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // first occupied bucket: each thread's first hit on its strided
  // buckets, then a block-wide min.  __ldcg reads L2, where the other
  // blocks' atomics landed.
  int first = nb;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    if (__ldcg(&cnt[b]) > 0) {
      first = b;
      break;
    }
  }
  first = __reduce_min_sync(0xffffffffu, first);
  if (threadIdx.x % 32 == 0) s_first[threadIdx.x / 32] = first;
  __syncthreads();
  if (threadIdx.x == 0) {
    int b0 = nb;
    for (int w = 0; w < kWarps; ++w) b0 = min(b0, s_first[w]);
    *found = b0 < nb;
    *val = b0 < nb ? __ldcg(&bmin[b0]) : kKeyInf;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a bucket count outside (0, kMaxBuckets].
// `cnt` holds nb + 1 int32 words, all 0 (word nb is the block ticket);
// `bmin` holds nb int64 words, all KEY_INF.
extern "C" int wheel_scan_launch(const void* keys, const void* slot,
                                 void* cnt, void* bmin, void* val,
                                 void* found, int n, int nb, void* stream) {
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
      static_cast<const int32_t*>(slot), n, nb, static_cast<int*>(cnt),
      static_cast<long long*>(bmin), static_cast<long long*>(val),
      static_cast<bool*>(found));
  return static_cast<int>(cudaGetLastError());
}
