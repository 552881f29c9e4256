// The idle-reactivation recurrence of the dense ingest (kernel K3).
//
// Replaces no TPU kernel: the JAX package applies an op batch with a
// lax.scan over its rows (dmclock_tpu/engine/kernels.py ingest), one
// row a scan step, which XLA keeps on the TPU.  The port applies the
// batch in one fixed-shape pass of dense tensor ops
// (dmclock_tpu_torch/engine/kernels.py _ingest_dense); the one part of
// the scan that is a true recurrence along the rows is left to this
// kernel.  An ADD to an idle client (reference dmclock_server.h:937-985)
// shifts its proportion tags by (lowest - t), where lowest is the least
// effective proportion tag among the clients scheduling at that moment,
// and once it is in, the client's own tag joins that set for the rows
// after it.  The pass computes, for each reactivating row k (in row
// order), every input that does not depend on an earlier reactivation:
//
//   rows[0][k]  m     least tag of the clients whose status is fixed
//                     without the recurrence (KEY_INF if none)
//   rows[1][k]  any0  1 if there is at least one such client
//   rows[2][k]  base  the row's new head proportion tag
//   rows[3][k]  pd0   its prop_delta if it does not shift
//   rows[4][k]  act   1 if the client is active (it then joins the set)
//   rows[5][k]  t     the arrival time
//   rows[6][k]  end   the first reactivating row at which the client
//                     has left the set again (a CREATE of its slot later
//                     in the batch), count if never
//
// and the kernel walks the rows k < count in order:
//
//   low  = min(m, the joined tags live at k);  any = any0 || one is live
//   pd   = (any && low < LOWEST_PROP_TAG_TRIGGER) ? low - t : pd0
//   out[k] = pd;  if act: join base + pd, live for k < k' < end
//
// Arithmetic wraps as int64 does on the device and in the JAX package:
// low - t and base + pd are done in unsigned long long and cast back
// (signed overflow is undefined in C++).  The minimum is signed.
//
// Bound: it reads 56 bytes and writes 8 a row (0.64 MB at 10,000 rows,
// 0.19 us at 3.35 TB/s), so what a call costs is the launch (about
// 1 us) and the serial walk: a chain of dependent min/compare/sub/add
// steps a row.  The design keeps the chain free of memory latency: one
// block of kThreads threads loads kChunk rows at a time into shared
// memory, coalesced; thread 0 walks the chunk from shared memory while
// nothing else is in flight, then the block writes the chunk's results
// out.  A joined tag that never leaves (end == count, every row of a
// batch without a re-created slot) folds into one running minimum; one
// that leaves goes to a list in the workspace that thread 0 scans and
// compacts at each row (empty unless a slot is re-created after a
// reactivation in the same batch).  A later PR could scan the rows in
// log depth: each row's step is a monotone min-plus map of low.
//
// Plain C interface, loaded with ctypes (dmclock_tpu_torch/engine/_ext.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr long long kKeyInf = 0x7fffffffffffffffLL;
// LOWEST_PROP_TAG_TRIGGER = MAX_TAG // 2, MAX_TAG = 2^62
constexpr long long kTrigger = 1LL << 61;
constexpr int kFields = 7;
constexpr int kThreads = 256;
constexpr int kChunk = 512;

__device__ __forceinline__ long long wrap_sub(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) -
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__global__ void __launch_bounds__(kThreads)
ingest_scan_kernel(const long long* __restrict__ rows,
                   const long long* __restrict__ count,
                   long long* __restrict__ out, long long* __restrict__ ws,
                   int b) {
  __shared__ long long in[kFields][kChunk];
  __shared__ long long res[kChunk];
  long long n = *count;
  if (n > b) n = b;
  if (n < 0) n = 0;
  // thread 0's carry: the running minimum of the joined tags that never
  // leave, whether any has joined, and the length of the list of those
  // that leave (ws[i] = tag, ws[b + i] = end)
  long long low_p = kKeyInf;
  bool any_p = false;
  int nf = 0;
  for (long long c0 = 0; c0 < n; c0 += kChunk) {
    const int len = static_cast<int>(n - c0 < kChunk ? n - c0 : kChunk);
    for (int f = 0; f < kFields; ++f)
      for (int i = threadIdx.x; i < len; i += kThreads)
        in[f][i] = rows[static_cast<long long>(f) * b + c0 + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < len; ++i) {
        const long long k = c0 + i;
        long long low = in[0][i] < low_p ? in[0][i] : low_p;
        bool any = in[1][i] != 0 || any_p;
        int kept = 0;
        for (int j = 0; j < nf; ++j) {
          const long long e = ws[b + j];
          if (e > k) {
            const long long v = ws[j];
            if (v < low) low = v;
            any = true;
            ws[kept] = v;
            ws[b + kept] = e;
            ++kept;
          }
        }
        nf = kept;
        long long pd = in[3][i];
        if (any && low < kTrigger) pd = wrap_sub(low, in[5][i]);
        res[i] = pd;
        if (in[4][i] != 0) {
          const long long v = wrap_add(in[2][i], pd);
          const long long e = in[6][i];
          if (e >= n) {
            if (v < low_p) low_p = v;
            any_p = true;
          } else if (e > k + 1) {
            ws[nf] = v;
            ws[b + nf] = e;
            ++nf;
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) out[c0 + i] = res[i];
    __syncthreads();
  }
}

}  // namespace

// rows: int64[7, b]; count: int64[] (the rows to walk, read on the
// device); out: int64[b] (rows past count untouched); ws: int64[2, b].
extern "C" int ingest_scan_launch(const void* rows, const void* count,
                                  void* out, void* ws, int b, void* stream) {
  if (b < 0) return static_cast<int>(cudaErrorInvalidValue);
  ingest_scan_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(rows),
      static_cast<const long long*>(count), static_cast<long long*>(out),
      static_cast<long long*>(ws), b);
  return static_cast<int>(cudaGetLastError());
}
